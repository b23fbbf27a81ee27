"""The port's spans and counters (splatloam_tpu_torch/profiling.py and
their call sites): frame ids, nesting, the rings, the torch.profiler
ranges, the optimize blocks' spans and the graph counters.  On the CPU
at the e2e test's scale (16x128, GT tracking, a keyframe every third
frame); the ``cuda`` tests run the captured blocks on the card."""
import contextlib
from collections import Counter

import numpy as np
import pytest
import synthetic
import torch

from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch import graphs, profiling
from splatloam_tpu_torch.logging_backends import reset_datalogger
from splatloam_tpu_torch.preprocessing import Preprocessor
from splatloam_tpu_torch.profiling import Profiler
from splatloam_tpu_torch.slam import SLAM

N_FRAMES = 5
KEYFRAMES = (0, 3)      # frame 0 opens the map; 3 is tracked 3 > 2 frames

# each child span's parent, for the spans the program records
PARENT = {
    "preprocess.pack": "preprocess", "preprocess.upload": "preprocess",
    "preprocess.project": "preprocess",
    "track": "process", "track.set_source": "track",
    "track.align": "track", "map_update": "process",
    "register_keyframe": "process",
    "map.densify": "map_update", "map.stack_kf": "map_update",
    "map.optimize": "map_update", "map.prune": "map_update",
    "map.densify.render": "map.densify", "map.densify.core": "map.densify",
    "map.densify.read": "map.densify",
    "map.optimize.draw": "map.optimize", "map.optimize.load": "map.optimize",
    "map.optimize.start_block": "map.optimize",
    "map.optimize.body": "map.optimize",
    "map.optimize.capture": "map.optimize",
    "map.optimize.replay": "map.optimize",
    "map.optimize.results": "map.optimize",
    "map.optimize.drain": "map.optimize",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path):
    """tests/synthetic.py's settings for the port, with 4-iteration
    updates in 2 blocks of 2."""
    return pconfig.from_dict(pconfig.Configuration, {
        "preprocessing": {"image_height": 16, "image_width": 128,
                          "depth_min": 0.5, "depth_max": 30.0,
                          "enable_normal_estimation": False,
                          "enable_ground_segmentation": False},
        "mapping": {"num_iterations": 3, "densify_percentage": 0.6,
                    "densify_threshold_opacity": 0.5,
                    "prob_view_last_keyframe": 0.4,
                    "pruning_min_opacity": 0.05, "opt_scaling_max": 1.0,
                    "lmodel_threshold_ngaussians": 60000},
        "tracking": {"method": "gt", "keyframe_threshold_nframes": 2,
                     "keyframe_threshold_distance": -1,
                     "keyframe_threshold_fitness": -1},
        "compute": {"backend": "cuda", "initial_capacity": 2048,
                    "keyframe_capacity": 8, "chunk": 256,
                    "rebin_every": 2},
        "logging": {"enable": False},
        "output": {"folder": str(tmp_path / "results"), "writer": "tum"},
    })


def _run(tmp_path, device) -> SLAM:
    """N_FRAMES sweeps through Preprocessor + SLAM on a fresh profiler."""
    cfg = _cfg(tmp_path)
    reset_datalogger()
    profiling.reset_profiler()
    rng = np.random.default_rng(0)
    poses = synthetic.straight_trajectory(N_FRAMES, step=0.4)
    pre = Preprocessor(cfg, device=device)
    slam = SLAM(cfg, device=device)
    for i, pose in enumerate(poses):
        slam.process(pre(synthetic.sensor_cloud(rng, pose), 0.1 * i,
                         gt_pose=pose))
    return slam


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    slam = _run(tmp_path_factory.mktemp("spans"), "cpu")
    prof = profiling.get_profiler()
    return {"slam": slam, "prof": prof, "spans": prof.spans()}


def _optimize_inputs(slam):
    """The mapper's programs, pool, keyframe stack and draws for one more
    update of the newest submap."""
    mapper = slam.mapper
    model = mapper.model
    cam = model.keyframes[-1].camera
    progs = mapper.programs_for(cam.height, cam.width, model.capacity)
    bucket = slam.cfg.compute.keyframe_capacity
    kf_cap = -(-len(model.keyframes) // bucket) * bucket
    kf = mapper._stack_keyframes(kf_cap)
    idx = mapper._draw_keyframes(kf.probs, progs.n_blocks(),
                                 len(model.keyframes) - 1)
    return progs, model, kf, idx


def test_frame_ids_are_the_sweeps_indices(run):
    spans = run["spans"]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.frame)
    assert by_name["preprocess"] == list(range(N_FRAMES))
    assert by_name["process"] == list(range(N_FRAMES))
    assert by_name["map_update"] == list(KEYFRAMES)
    assert by_name["track"] == list(range(1, N_FRAMES))
    assert {s.frame for s in spans} == set(range(N_FRAMES))
    assert run["prof"].frame == N_FRAMES - 1


def test_children_nest_in_their_parents(run):
    spans = run["spans"]
    by_id = {s.id: s for s in spans}
    assert sorted(by_id) == list(range(len(spans)))    # none dropped
    for s in spans:
        if s.parent < 0:
            assert s.name in ("preprocess", "process"), s
            continue
        p = by_id[s.parent]
        assert p.name == PARENT[s.name], (s, p)
        assert p.frame == s.frame
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert p.id < s.id
    # the children of an update's phases, in the order they ran
    for frame in KEYFRAMES:
        opt = [s.name for s in spans
               if s.frame == frame and PARENT.get(s.name) == "map.optimize"]
        assert opt == ["map.optimize.draw", "map.optimize.drain"], opt
        den = [s.name for s in spans
               if s.frame == frame and PARENT.get(s.name) == "map.densify"]
        # the first update of a submap renders nothing before densify
        assert den == (["map.densify.core", "map.densify.read"]
                       if frame == 0 else
                       ["map.densify.render", "map.densify.core",
                        "map.densify.read"]), den
    # the phase statistics hold every span's duration
    stats = run["prof"].stats
    for name, n in Counter(s.name for s in spans).items():
        assert stats[name].count == n
    assert stats["map_update"].samples == pytest.approx(
        [1e-9 * (s.end_ns - s.start_ns) for s in spans
         if s.name == "map_update"])


def test_counters_are_tagged_by_frame(run):
    prof = run["prof"]
    counts = prof.counts()
    assert [(c.name, c.frame) for c in counts] == [
        (name, f) for f in KEYFRAMES
        for name in ("map.densify.added", "map.keyframes",
                     "map.replay.newest", "kernel.K11_image_loss",
                     "map.prune.removed")]
    model = run["slam"].local_models[-1]
    added = sum(c.value for c in counts if c.name == "map.densify.added")
    removed = sum(c.value for c in counts if c.name == "map.prune.removed")
    assert added - removed == model.no_gaussians > 0
    assert prof.counters["map.densify.added"] == added
    assert "map.densify.added" in prof.report()


def test_optimize_static_uncaptured_spans_each_block(run):
    progs, model, kf, idx = _optimize_inputs(run["slam"])
    assert progs.n_blocks() == 2
    profiling.reset_profiler()
    out = progs.optimize_static(model.surfels, model.adam, kf, idx,
                                capture=False)
    assert out[3] == 4
    names = [s.name for s in profiling.get_profiler().spans()]
    assert names == ["map.optimize.load",
                     "map.optimize.start_block", "map.optimize.body",
                     "map.optimize.start_block", "map.optimize.body",
                     "map.optimize.results"]


class StandInGraph:
    """What graphs._record returns on the CPU: replaying runs the body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def test_captured_blocks_span_one_capture_then_replays(run, monkeypatch):
    """The capture protocol through a stand-in graph: the signature's
    first block is the capture span, every later one a replay span, and
    the counters follow the frames."""
    monkeypatch.setattr(graphs, "_check_device", lambda tensors: None)
    monkeypatch.setattr(graphs, "_side_stream", contextlib.nullcontext)
    monkeypatch.setattr(graphs, "_record",
                        lambda body: (StandInGraph(body), None, 0))
    progs, model, kf, idx = _optimize_inputs(run["slam"])
    profiling.reset_profiler()
    prof = profiling.get_profiler()
    for _ in range(2):
        prof.next_frame()
        progs.optimize_static(model.surfels, model.adam, kf, idx,
                              capture=True)
    progs.release_graphs()
    blocks = [(s.frame, s.name) for s in prof.spans()
              if s.name.startswith(("map.optimize.capture",
                                    "map.optimize.replay"))]
    assert blocks == [(0, "map.optimize.capture"),
                      (0, "map.optimize.replay"),
                      (1, "map.optimize.replay"),
                      (1, "map.optimize.replay")]
    assert [(c.name, c.frame) for c in prof.counts()] == [
        ("graph.captures", 0), ("graph.replays", 0),
        ("graph.replays", 1), ("graph.replays", 1)]
    # the counters outlive the released graph
    assert prof.counters == {"graph.captures": 1, "graph.replays": 3}


def test_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "RING_SPANS", 4)
    monkeypatch.setattr(profiling, "RING_COUNTS", 3)
    prof = Profiler()
    for i in range(6):
        prof.next_frame()
        with prof.phase("a"):
            prof.count("c", i)
    assert [(s.id, s.frame) for s in prof.spans()] == [
        (2, 2), (3, 3), (4, 4), (5, 5)]
    assert [(c.frame, c.value) for c in prof.counts()] == [
        (3, 3.0), (4, 4.0), (5, 5.0)]
    assert prof.stats["a"].count == 6 and prof.counters["c"] == 15
    # a span opened before the first frame carries -1
    fresh = Profiler()
    with fresh.phase("early"):
        pass
    assert fresh.spans()[0].frame == -1


def test_spans_reach_a_torch_profiler_trace_and_only_then(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    prof = Profiler()
    with prof.phase("outer"), prof.phase("outer.inner"):
        torch.ones(4).sum()
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with prof.phase("outer"), prof.phase("outer.inner"):
            torch.ones(4).sum()
    assert opened == ["phase.outer", "phase.outer.inner"]
    names = {e.name for e in tp.events()}
    assert {"phase.outer", "phase.outer.inner"} <= names
    assert [s.name for s in prof.spans()] == [
        "outer.inner", "outer", "outer.inner", "outer"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: captured graphs run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """The captured blocks' spans and counters on the card."""

    def test_captured_update_spans_and_counters(self, card, tmp_path):
        _run(tmp_path, card)
        prof = profiling.get_profiler()
        spans = prof.spans()
        for frame, first in zip(KEYFRAMES, (True, False)):
            blocks = [s.name for s in spans if s.frame == frame
                      and s.name in ("map.optimize.capture",
                                     "map.optimize.replay",
                                     "map.optimize.body")]
            assert blocks == (["map.optimize.capture"] if first else []) \
                + ["map.optimize.replay"] * (2 - first), (frame, blocks)
        counts = Counter((c.name, c.frame) for c in prof.counts()
                         if c.name.startswith("graph."))
        assert counts == {("graph.captures", 0): 1,
                          ("graph.replays", 0): 1,
                          ("graph.replays", 3): 2}

    def test_block_loop_reads_nothing_back_until_the_drain(self, card,
                                                           tmp_path):
        slam = _run(tmp_path, card)
        progs, model, kf, idx = _optimize_inputs(slam)
        torch.cuda.synchronize()
        profiling.reset_profiler()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = progs.optimize_static(model.surfels, model.adam, kf, idx,
                                        capture=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert np.isfinite(float(out[2]))
        names = [s.name for s in profiling.get_profiler().spans()]
        assert names.count("map.optimize.replay") == 2
        assert "map.optimize.capture" not in names
