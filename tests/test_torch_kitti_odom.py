"""The shipped KITTI odometry config (configs/kitti/kitti-00-odom.yaml:
gsaligner tracking on every frame, a keyframe at 5 m or fitness < 0.3,
uniform keyframe replay, one submap that never closes) through the
port's Preprocessor and SLAM.process on the CPU, at 32x256 with keyframe
updates of one 4-iteration block, on the benchmark's street canyon at
KITTI's field of view and 0.7 m a sweep.  The tracked poses are held to the generator's,
each frame's Gauss-Newton pose to the benchmark's plain float64 solve
from the same inputs, each keyframe's target render to the plain
renderer, and the tracker's and the mapper's spans and counters to what
the run did.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmark"))

from reference import gauss_newton as gn  # noqa: E402
from reference import raster  # noqa: E402
from traffic.canyon import SweepStream  # noqa: E402

from splatloam_tpu_torch import logging_backends  # noqa: E402
from splatloam_tpu_torch.config import load_configuration  # noqa: E402
from splatloam_tpu_torch.preprocessing import Preprocessor  # noqa: E402
from splatloam_tpu_torch.profiling import (get_profiler,  # noqa: E402
                                           reset_profiler)
from splatloam_tpu_torch.slam import SLAM  # noqa: E402

H, W = 32, 256
N_FRAMES = 18          # keyframes at 0 m, ~5.6 m and ~11.2 m
SEED = 4_000_000_021
# the benchmark's tiny tracking cell's limits at this size
# (benchmark/tests/tiny.py TRACK_LIMITS): pose_rpe_m, track_gap_m
POSE_TOL_M = 2.0
GN_TOL_M = 0.05
# the target render against the plain renderer: the share of pixels whose
# validity (alpha > 0.5, depth above depth_min) differs, or whose depth
# differs beyond 1e-5 relative where both are valid
TARGET_MISMATCH = 0.06
TRAFFIC = dict(scene="street_canyon", beams=H, columns=W,
               fov_deg=[-24.8, 2.0], max_range_m=50.0, start_m=0.0,
               frame_dt_s=0.1, step_m=0.7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.slam; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def _config(overrides=()):
    return load_configuration(
        ROOT / "configs/kitti/kitti-00-odom.yaml",
        ["logging.enable=false", f"preprocessing.image_height={H}",
         f"preprocessing.image_width={W}", "mapping.num_iterations=3",
         "compute.rebin_every=4", *overrides])


@pytest.fixture(scope="module")
def drive():
    """The sweeps through the port, with each GN solve's inputs and pose
    and each keyframe's target and pool kept."""
    torch.set_num_threads(1)
    cfg = _config()
    reset_profiler()
    logging_backends.reset_datalogger()
    stream = SweepStream(TRAFFIC, SEED, "cpu")
    pre = Preprocessor(cfg, device="cpu")
    slam = SLAM(cfg, device="cpu", seed=7)
    aligner = slam.tracker.aligner
    solves, targets = [], []
    align, set_target = aligner.align, aligner.set_target

    def tapped_align(iguess):
        depth, pts, normals, valid, K = aligner._target[:5]
        T = align(iguess)
        solves.append(dict(guess=np.array(iguess, np.float64), T=T,
                           inputs=[t.clone() for t in (
                               *aligner._source, depth, pts, normals,
                               valid, K)]))
        return T

    def tapped_target(frame):
        set_target(frame)
        s = aligner.model.surfels
        act = s.active
        cam = frame.camera_in_model()
        targets.append(dict(
            pool=(s.params.xyz[act].clone(), s.scaling[act].clone(),
                  s.params.quat[act].clone(), s.opacity[act].clone()),
            T_cw=cam.T_cw.clone(), K=cam.K.clone(),
            depth=aligner._target[0].clone(),
            valid=aligner._target[3].clone()))
    aligner.align = tapped_align
    aligner.set_target = tapped_target
    for i in range(N_FRAMES):
        slam.process(pre(stream.sweep(i), stream.timestamp(i),
                         gt_pose=stream.pose(i)))
    return dict(cfg=cfg, slam=slam, stream=stream, solves=solves,
                targets=targets, prof=get_profiler())


def test_the_drive_makes_three_keyframes_in_one_submap(drive):
    slam = drive["slam"]
    assert len(slam.local_models) == 1
    assert len(slam.local_models[0].keyframes) >= 3
    assert len(drive["solves"]) == N_FRAMES - 1


def test_tracked_poses_follow_the_generator(drive):
    stream = drive["stream"]
    est = np.stack(drive["slam"].world_T_odom)
    gt = np.stack([stream.pose(i) for i in range(N_FRAMES)])
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.max() <= POSE_TOL_M, err
    # the drive is tracked, not held: the last pose is ~11.9 m on
    assert est[-1, 0, 3] > 0.7 * (N_FRAMES - 1) - POSE_TOL_M


def test_each_solve_matches_the_plain_gauss_newton(drive):
    s = gn.settings(drive["cfg"])
    gaps = []
    for f in drive["solves"]:
        ref = gn.align(f["guess"], *f["inputs"], s)
        gaps.append(gn.point_gap(f["inputs"][0], f["inputs"][1], f["T"],
                                 ref))
    assert max(gaps) <= GN_TOL_M, gaps


def test_each_target_render_matches_the_plain_renderer(drive):
    dmin = float(drive["cfg"].preprocessing.depth_min)
    for t in drive["targets"]:
        ref = raster.render(*t["pool"], t["T_cw"], t["K"], H, W)
        rdepth = ref["depth"]
        rvalid = (ref["alpha"] > 0.5) & (rdepth > dmin)
        both = rvalid & t["valid"]
        gap = (t["depth"] - rdepth).abs() / torch.where(both, rdepth, 1.0)
        bad = (rvalid != t["valid"]) | (both & (gap > 1e-5))
        assert float(bad.float().mean()) <= TARGET_MISMATCH
        assert float(t["valid"].float().mean()) > 0.3


def test_spans_and_counters_count_the_run(drive):
    prof, slam = drive["prof"], drive["slam"]
    n_kf = len(slam.local_models[0].keyframes)
    n_tracked = N_FRAMES - 1
    spans = prof.spans()
    names = [s.name for s in spans]
    assert names.count("track.target") == n_kf
    assert names.count("track") == names.count("track.align") == n_tracked
    counts = prof.counts()
    iters = [c.value for c in counts if c.name == "track.gn.iters"]
    assert len(iters) == n_tracked
    cap = int(drive["cfg"].tracking.gsaligner.num_iterations
              if drive["cfg"].tracking.gsaligner else 30)
    assert all(1 <= v <= cap for v in iters)
    assert prof.increments["track.gn.iters"] == n_tracked
    kfs = [c.value for c in counts if c.name == "map.keyframes"]
    assert kfs == list(range(1, n_kf + 1))
    # every update's one block optimizes its newest keyframe (drawn from
    # uniform replay alone, 1 in n of them would)
    newest = [c.value for c in counts if c.name == "map.replay.newest"]
    assert newest == [1] * n_kf
    report = prof.report()
    for name in ("track.gn.iters", "map.keyframes", "map.replay.newest",
                 "track.target"):
        assert name in report


def test_replay_weights_favour_the_newest_keyframe():
    """P(kf i) proportional to (1 - p)^(n - i) p over the insertion order:
    the newest keyframe is drawn with weight p, each older one with
    (1 - p) times the next's; uniform without p; padded with zeros."""
    from splatloam_tpu_torch.slam.mapper import sample_geometric_probs
    probs = sample_geometric_probs(4, 0.4, 8)
    w = 0.4 * 0.6 ** np.arange(3, -1, -1)
    np.testing.assert_allclose(probs[:4], w / w.sum(), rtol=1e-6)
    assert probs[3] == probs.max() and not probs[4:].any()
    np.testing.assert_allclose(sample_geometric_probs(4, None, 8)[:4], 0.25)
    np.testing.assert_allclose(sample_geometric_probs(4, -1.0, 4), 0.25)
    assert sample_geometric_probs(1, 0.4, 4).tolist() == [1, 0, 0, 0]


def test_every_update_draws_its_newest_keyframe():
    """The repair of the tracker's loss on the drive: the first block of an
    update optimizes the newest keyframe.  Drawn alone, 13 blocks of
    uniform replay over 50 keyframes (kitti-00-odom.yaml's 201 iterations
    at rebin 16) leave it out of 77% of the updates; here of none, and
    the other blocks keep their draws."""
    from splatloam_tpu_torch.slam.mapper import Mapper, sample_geometric_probs
    cfg = _config()
    n, blocks = 50, 13
    probs = sample_geometric_probs(n, None, 64)
    drawn = Mapper(cfg, device="cpu", seed=3)
    plain = torch.Generator().manual_seed(3)
    missed = 0
    for _ in range(40):
        idx = drawn._draw_keyframes(probs, blocks, n - 1)
        ref = torch.multinomial(torch.as_tensor(probs), blocks,
                                replacement=True, generator=plain)
        assert idx[0] == n - 1
        assert torch.equal(idx[1:], ref[1:])
        missed += int((ref != n - 1).all())
    assert missed >= 20


@pytest.mark.parametrize("closes_at", [None, 30])
def test_pool_growth_of_a_submap_that_never_closes(closes_at):
    """kitti-00-odom.yaml's submap never closes: when an update's densify
    would not fit, its pool grows by room for eight such updates, in
    whole 1024-slot units, and again by the same step.  Given a keyframe
    threshold (30, as the NCD mapping config has) the submap closes and
    its pool doubles as before."""
    from splatloam_tpu_torch.model.local_model import LocalModel
    from splatloam_tpu_torch.slam.mapper import MapperPrograms
    over = [] if closes_at is None else \
        [f"mapping.lmodel_threshold_nkeyframes={closes_at}"]
    cfg = _config(over)
    model = LocalModel(cfg, device="cpu")
    needed = MapperPrograms(cfg, H, W, model.capacity).max_new
    assert needed == int(np.ceil(0.3 * H * W)) + 1 == 2459
    step = 20 * 1024                  # 8 * 2459 = 19,672 slots, rounded up
    caps = [model.capacity]
    for n_active in (32_768 - needed, 32_768 - needed + 1, 53_000, 72_000):
        model.surfels.active[:n_active] = True
        model.ensure_free_slots(needed)
        assert model.capacity - model.no_gaussians >= needed
        caps.append(model.capacity)
    if closes_at is None:
        assert caps == [32_768, 32_768, 32_768 + step, 32_768 + 2 * step,
                        32_768 + 3 * step]
    else:
        assert caps == [32_768, 32_768, 65_536, 65_536, 131_072]
