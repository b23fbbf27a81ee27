"""A checkout in a temporary folder with one cell added as data files
alone: a configuration, a traffic mix and their BENCHMARK.json entries,
cut to a size the CPU runs in seconds (16x128 range images, 20-iteration
updates), with the plain PyTorch versions of the kernels.  The cell is
``ncd-recon.walk`` cut so (GT poses), or with ``tracking`` a tracking
cell: the shipped ``kitti-00-odom.yaml`` (gsaligner) at 32x256 on the
walk's scene and frame rate, with KITTI's HDL-64E field of view at 0.7 m
a sweep."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import yaml

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent

# limits of the tiny cell, from CPU readings at this size and seconds 3
# (sound runs, seeds 1-6: range_mismatch 0, render_mismatch 0, map_hole
# 0.18-0.27, map_normal_deg 18.0-21.0 in the one sector of 128 columns;
# optimize_frozen, seeds 1-3: map_normal_deg 28.7-30.3)
TINY_LIMITS = {"range_mismatch": 0.01, "render_mismatch": 0.01,
               "map_hole": 0.32, "map_normal_deg": 25.0}
# the tracking cell's (32x256: at 16x128, 16 beams over 26.8 degrees,
# the tracker lost the sweeps on 2 of 4 seeds), from CPU readings at
# 33-41 frames (sound, seeds 1-4 and 9: render_mismatch 0.022-0.031, the
# tile lists' overflow at this pool's size, pose_rpe_m 0.157-0.236,
# track_gap_m 0.0040-0.0071; track_frozen pose_rpe_m 20.3, track_short
# track_gap_m 3.17; the TF32 control: range_mismatch 0.78, render_mismatch
# 0.85-0.88, track_gap_m 0.0065-0.0199, apart from the sound runs' only
# at the cells' own size)
TRACK_LIMITS = {"range_mismatch": 0.01, "render_mismatch": 0.06,
                "pose_rpe_m": 2.0, "track_gap_m": 0.05}
# a window of 32 frames: segments of 20 m (29 sweeps) fit in it
TRACK_WINDOW = dict(frames=32)
# the tiny cells' window: the frames the first window update closes on
# (a sound CPU run's keyframe update at 16x128 takes seconds)
TINY_WINDOW_FRAMES = 6
TRACKING_YAML = "configs/kitti/kitti-00-odom.yaml"
KITTI_SENSOR = {"fov_deg": [-24.8, 2.0], "max_range_m": 50.0, "step_m": 0.7}


def merged_yaml(path: Path) -> dict:
    """A shipped YAML with its ``inherit_from`` chain merged in."""
    data = yaml.safe_load(Path(path).read_text())
    parent = data.pop("inherit_from", None)
    if parent is None:
        return data
    base = merged_yaml(CHECKOUT / parent)

    def merge(a, b):
        out = dict(a)
        for k, v in b.items():
            out[k] = (merge(out[k], v) if isinstance(v, dict)
                      and isinstance(out.get(k), dict) else v)
        return out
    return merge(base, data)


def tracking_config() -> dict:
    """The configuration file of a tracking cell: the shipped
    kitti-00-odom.yaml as run (its data paths are not read)."""
    config = merged_yaml(CHECKOUT / TRACKING_YAML)
    config["logging"] = {"enable": False}
    return {"name": "kitti-odom", "yaml": TRACKING_YAML,
            "reduced": {"logging": "the interactive viewer is off"},
            "assumed": {}, "config": config}


def make(tmp: Path, config: str = "ncd-recon", cell: str = "ncd-recon.walk",
         hw=None, iters: int = 20, tracking: bool = False) -> Path:
    """-> the new checkout's BENCHMARK.json; the cell is "tiny.cell"
    (16x128, or 32x256 with ``tracking``)."""
    tmp = Path(tmp)
    hw = hw or ((32, 256) if tracking else (16, 128))
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    c = (tracking_config() if tracking else
         json.loads((BENCH / "configs" / f"{config}.json").read_text()))
    c["config"]["preprocessing"].update(image_height=hw[0],
                                        image_width=hw[1])
    c["config"]["mapping"]["num_iterations"] = iters
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(c))
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    w["traffic"].update(beams=hw[0], columns=hw[1])
    w["setup"]["max_frames"] = 40
    w["window_frames"] = TINY_WINDOW_FRAMES
    w["limits"] = {k: TINY_LIMITS[k] for k in w["limits"]}
    if tracking:
        w["traffic"].update(KITTI_SENSOR)
        w["setup"] = {"updates": 2, "max_frames": 40}
        w["limits"] = dict(TRACK_LIMITS)
    (tmp / "benchmark/workloads/tiny.cell.json").write_text(json.dumps(w))
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="benchmark/configs/tiny.json"))
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": f"{cell} cut to {hw[0]}x{hw[1]}"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.cell")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp / "BENCHMARK.json"


def run(path: Path, seed: int = 5, frames: int | None = None,
        seconds: float = 600.0, trace=False, control=False, fault=None,
        tick: float | None = None):
    """One CPU run of the tiny cell -> (result, checks): a window of
    ``frames`` frames (the cell's ``window_frames`` where None) under a
    guard of ``seconds``.  With ``tick`` the harness's clock reads
    ``tick`` seconds more at every call (two ticks a frame) and its
    ``sleep(s)`` moves it on by ``s``, so that the guard closes a window
    on the same frame on any machine."""
    import time
    import types

    import harness
    from manifest import Manifest
    if frames is not None:
        cell = path.parent / "benchmark" / "workloads" / "tiny.cell.json"
        wl = json.loads(cell.read_text())
        wl["window_frames"] = frames
        cell.write_text(json.dumps(wl))
    m = Manifest(path, path.parent / "benchmark")
    clock = harness.time
    if tick is not None:
        now = [0.0]

        def tock():
            now[0] += tick
            return now[0]

        def sleep(s):
            now[0] += s
        harness.time = types.SimpleNamespace(perf_counter=tock, sleep=sleep)
    try:
        return harness.run_cell(m, "tiny.cell", seed, seconds, trace, "cpu",
                                time.perf_counter(), control=control,
                                fault=fault)
    finally:
        harness.time = clock
