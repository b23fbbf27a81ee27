"""One run of one cell: set-up, the measured window, the traced
sub-window, the readers, the comparison with the plain reference (the
judge's own checks, then those the cell brings in ``reference/checks/``).

The window is closed-loop, as the ``slam`` command replays a recorded
sequence: sweep i + 1 is handed over when frame i has returned.  A
frame's time runs from the hand-over of its sweep (a host float32 array)
to ``Preprocessor`` until ``SLAM.process`` has returned and the device is
synchronised; making the sweep lies outside it.  The window is the first
``window_frames`` frames after set-up (``workloads/<cell>.json``): the
same frames of the same stream on every program, so that the peak
memory and the comparison read the same work on a faster program as on
a slower one.  ``--seconds`` is a guard: a window whose frames' times
reach it before ``window_frames`` frames closes there, and the result's
``window`` records how many frames it holds and that the guard cut it;
the metrics are read over those frames.

With ``--trace 1`` the program's phases are forwarded into a
``torch.profiler`` trace of the window's first frames, up to and with
``trace_updates`` keyframe updates (the traced sub-window), the pool and
views of each update in it are kept for the kernels' counts, and the
per-layer metrics are read: host phases over the frames outside the
sub-window, the device's busy time and kernels inside it.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import tracing  # noqa: E402
from reference import judge  # noqa: E402
from traffic.canyon import SweepStream, stream_seed  # noqa: E402

PHASES = ("track", "map_update", "map.optimize")


class Run:
    """What a run recorded, handed to every metric's reader."""

    def __init__(self, cell: dict, workload: dict, cfg):
        self.cell, self.workload, self.cfg = cell, workload, cfg
        self.frames: list[dict] = []      # the window's frames, in order
        self.setup_s = 0.0
        self.window_s = 0.0               # sum of the frames' times
        self.memory_peak_bytes = 0
        # traced runs only
        self.traced = False
        self.device_events: list[tuple] = []  # (name, start_ns, dur_ns)
        self.host_ranges: list[tuple] = []    # (name, start_ns, end_ns)
        self.updates: list[dict] = []     # pools and views, traced window

    @property
    def untraced_frames(self) -> list[dict]:
        return [f for f in self.frames if not f["traced"]]


def build_config(config_file: dict):
    from splatloam_tpu_torch.config import Configuration, from_dict
    return from_dict(Configuration, copy.deepcopy(config_file["config"]))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase_marks(prof) -> dict:
    return {name: len(prof.stats[name].samples) for name in PHASES}


def _phase_deltas(prof, marks: dict) -> dict:
    return {name: float(sum(prof.stats[name].samples[marks[name]:]))
            for name in PHASES}


# the Program whose densify renders are kept (one at a time in a process)
_CURRENT: list = [None]


def _tap_densify() -> None:
    """Hand each render that densify reads (every keyframe update's but a
    submap's first: the pool before the update, rendered by the
    rasterizer at the keyframe) to the current Program on its way."""
    from splatloam_tpu_torch.slam import mapper as mapper_mod
    if getattr(mapper_mod.densify_core, "bench_tap", False):
        return
    core = mapper_mod.densify_core

    def densify_core(surfels, adam, camera, gumbel, pkg, **kw):
        prog = _CURRENT[0]
        if prog is not None and pkg is not None:
            pkg = prog.densify_render(surfels, camera, pkg)
        return core(surfels, adam, camera, gumbel, pkg, **kw)
    densify_core.bench_tap = True
    mapper_mod.densify_core = densify_core


class Program:
    """The program under test, fed frame by frame."""

    def __init__(self, cfg, stream: SweepStream, seed: int, device):
        from splatloam_tpu_torch import profiling
        from splatloam_tpu_torch.logging_backends import reset_datalogger
        from splatloam_tpu_torch.preprocessing import Preprocessor
        from splatloam_tpu_torch.slam import SLAM
        profiling.reset_profiler()
        reset_datalogger()
        self.prof = profiling.get_profiler()
        self.device = torch.device(device)
        self.stream = stream
        self.pre = Preprocessor(cfg, device=self.device)
        self.slam = SLAM(cfg, device=self.device, seed=stream_seed(seed, 3))
        self.next_index = 0
        # the newest densify render: references only, nothing is copied
        # (the pool it rendered is not written again)
        self.last_render: dict | None = None
        _tap_densify()
        _CURRENT[0] = self

    def densify_render(self, surfels, camera, pkg) -> dict:
        self.last_render = dict(index=self.next_index - 1, surfels=surfels,
                                T_cw=camera.T_cw, K=camera.K,
                                alpha=pkg["rend_alpha"],
                                depth=pkg["surf_depth"])
        return pkg

    def close(self) -> None:
        if _CURRENT[0] is self:
            _CURRENT[0] = None

    def n_updates(self) -> int:
        return len(self.prof.stats["map_update"].samples)

    def frame(self, traced: bool = False) -> dict:
        """Process the next sweep -> the frame's record."""
        i = self.next_index
        self.next_index += 1
        cloud = self.stream.sweep(i)
        marks = _phase_marks(self.prof)
        rec_fn = (torch.profiler.record_function if traced
                  else lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        with rec_fn("bench.frame"):
            with rec_fn("bench.preprocess"):
                frame = self.pre(cloud, self.stream.timestamp(i),
                                 gt_pose=self.stream.pose(i))
            if traced:
                _sync(self.device)
            t1 = time.perf_counter()
            with rec_fn("bench.process"):
                self.slam.process(frame)
                _sync(self.device)
        t2 = time.perf_counter()
        phases = _phase_deltas(self.prof, marks)
        updated = phases["map_update"] > 0.0
        return dict(index=i, ms=(t2 - t0) * 1e3, pre_ms=(t1 - t0) * 1e3,
                    process_ms=(t2 - t1) * 1e3, phases=phases,
                    updated=updated,
                    iters=int(self.slam.mapper.last_iters) if updated else 0,
                    traced=traced)


def _forward_phases(prof):
    """Open a profiler range around each of the program's phases."""
    original = prof.phase

    def phase(name):
        @contextlib.contextmanager
        def both():
            with torch.profiler.record_function(f"phase.{name}"):
                with original(name):
                    yield
        return both()
    prof.phase = phase


def _keep_update(prog: Program) -> dict:
    """The pool and the keyframe views of the update that just ran."""
    lm = prog.slam.local_models[-1]
    s = lm.surfels
    act = s.active
    views = []
    for kf in lm.keyframes:
        views.append(torch.as_tensor(np.linalg.inv(kf.model_T_frame),
                                     dtype=torch.float32,
                                     device=prog.device))
    cam = lm.keyframes[-1].camera
    return dict(xyz=s.params.xyz[act].clone(),
                scaling=torch.exp(s.params.log_scale[act]),
                quat=s.params.quat[act].clone(),
                opacity=torch.sigmoid(s.params.logit_opacity[act]),
                views=views, K=[kf.camera.K.clone() for kf in lm.keyframes],
                height=cam.height, width=cam.width,
                iters=int(prog.slam.mapper.last_iters))


def _kineto_events(p):
    """(device events, host ranges) of a finished torch.profiler run."""
    dev, host = [], []
    for e in p.profiler.kineto_results.events():
        try:
            start, dur = e.start_ns(), e.duration_ns()
        except AttributeError:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        name = e.name()
        if name.startswith(("phase.", "bench.")):
            # the ranges show on the device's time line too: host only
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append((name, start, start + dur))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((name, start, dur))
    return dev, host


def run_cell(manifest, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False,
             fault: str | None = None) -> tuple[dict, list]:
    """-> (the result line's object, the compared numbers)."""
    device = torch.device(device)
    cell = manifest.cell(cell_name)
    workload = manifest.workload_file(cell)
    cfg = build_config(manifest.config_file(cell))
    # the checks the cell brings: a limit without one ends the run here
    further = {name: manifest.check(name) for name in workload["limits"]
               if name not in judge.BUILTIN}
    run = Run(cell, workload, cfg)
    stream = SweepStream(workload["traffic"], seed, device)
    prog = Program(cfg, stream, seed, device)

    # set-up: frames through the first keyframe updates, so that the
    # kernels are built and the first graphs captured before the window
    setup = workload["setup"]
    while (prog.n_updates() < setup["updates"]
           or prog.next_index < setup.get("min_frames", 0)):
        if prog.next_index >= setup["max_frames"]:
            raise RuntimeError(
                f"{prog.n_updates()} keyframe updates in "
                f"{prog.next_index} frames of set-up, "
                f"{setup['updates']} expected")
        prog.frame()
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    if fault is not None:
        import faults
        faults.plant(fault, prog)
    for check in further.values():
        if hasattr(check, "tap"):
            check.tap(prog)

    # the window; with ``trace``, its first frames profiled
    profiler = None
    if trace:
        run.traced = True
        _forward_phases(prog.prof)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        window_range = torch.profiler.record_function("bench.window")
        window_range.__enter__()
    n_frames = int(workload["window_frames"])
    elapsed_ms = 0.0
    while len(run.frames) < n_frames and elapsed_ms < seconds * 1e3:
        rec = prog.frame(traced=profiler is not None)
        run.frames.append(rec)
        elapsed_ms += rec["ms"]
        if profiler is not None and rec["updated"]:
            run.updates.append(_keep_update(prog))
        if profiler is not None and (
                len(run.updates) >= workload["trace_updates"]
                or len(run.frames) >= n_frames
                or elapsed_ms >= seconds * 1e3):
            window_range.__exit__(None, None, None)
            profiler.stop()
            run.device_events, run.host_ranges = _kineto_events(profiler)
            profiler = None
    _sync(device)
    run.window_s = elapsed_ms * 1e-3
    if device.type == "cuda":
        # the peak over the whole run, set-up included
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))

    n_up = sum(f["updated"] for f in run.frames)
    window = {"frames": len(run.frames), "window_frames": n_frames,
              "guard_cut": len(run.frames) < n_frames,
              "seconds": run.window_s, "updates": n_up,
              "last_index": run.frames[-1]["index"] if run.frames else None,
              **pool_state(prog)}
    print(f"window: {window}", file=sys.stderr)
    # what the window produced, then the program's state freed
    observed = judge.observe(prog, run, stream)
    observed_further = {name: check.observe(prog, run, stream)
                        for name, check in further.items()}
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in manifest.metrics_of(cell, kind):
        value = manifest.reader(m)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = judge.compare(observed, stream, cfg, workload, control=control)
    for name, check in further.items():
        value = check.compare(observed_further[name], stream, cfg, workload,
                              control)
        checks.append(dict(name=name, value=float(value),
                           limit=workload["limits"][name]))
    correct = all(c["value"] <= c["limit"] for c in checks
                  if c["limit"] is not None) and all(
        math.isfinite(c["value"]) for c in checks)
    result = {"correct": bool(correct), "attempted": len(run.frames),
              "failed": 0, "metrics": metrics,
              "device": device_record(device, run)}
    if trace:
        result["breakdown"] = tracing.breakdown(run)
    result["window"] = window
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result, checks


def pool_state(prog: Program) -> dict:
    """The newest submap's pool at the window's end: its capacity in
    slots, its active surfels, and the number of submaps."""
    lm = prog.slam.local_models[-1]
    return {"submaps": len(prog.slam.local_models),
            "capacity": int(lm.capacity), "surfels": lm.no_gaussians}


def device_record(device, run: Run) -> dict:
    if device.type == "cuda":
        rec = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if run.traced:
        busy, window = tracing.busy_and_window(run)
        rec["busy_s"], rec["window_s"] = busy, window
    return rec
