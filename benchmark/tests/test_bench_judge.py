"""The comparison's own arithmetic on made-up images: the render's
mismatch share, the measured surface's normals and the surfels' angle
to them; the tracking checks' pose error over segments, and the plain
Gauss-Newton solve against the port's."""
import importlib.util
import json

import numpy as np
import pytest
import torch

from manifest import HERE
from reference import gauss_newton as gn
from reference import range_image as ri
from reference.judge import normal_deg, render_mismatch
from traffic.canyon import SweepStream

_spec = importlib.util.spec_from_file_location(
    "pose_rpe_m", HERE / "reference" / "checks" / "pose_rpe_m.py")
_pose = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pose)
segment_error = _pose.segment_error
# float32 against float64 on one solve: the largest point gap (m).  The
# solve ends before it converges along the street (its weak axis), where
# the two precisions' paths part by up to ~5e-4 m (seeds 7-9, guesses 0,
# 0.5 and 0.65 m short)
GN_TOL_M = 1e-3


def test_render_mismatch_counts_alpha_everywhere_and_depth_where_covered():
    alpha = np.full((4, 8), 0.9)
    depth = np.full((4, 8), 10.0)
    assert render_mismatch(alpha, depth, alpha, depth) == 0.0
    a, d = alpha.copy(), depth.copy()
    a[0, 0] = 0.0                    # a pixel the program left uncovered
    d[1, 1] *= 1 + 1e-4              # a covered pixel's depth off
    assert render_mismatch(a, d, alpha, depth) == 2 / 32
    low = np.full((4, 8), 0.3)       # nobody covers: depth is not judged
    assert render_mismatch(low, depth * 2, low, depth) == 0.0


def test_surface_normals_of_a_wall():
    rng = np.random.default_rng(0)
    az = rng.uniform(-0.5, 0.5, 20000)
    el = rng.uniform(-0.3, 0.3, 20000)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1)
    cloud = (5.0 / d[:, :1] * d).astype(np.float32)   # the wall x = 5
    depth, valid, _, pts = ri.range_image(cloud, 32, 256, 1.0, 60.0,
                                          points=True)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=-1)[valid],
                               depth[valid])
    n, where = ri.surface_normals(pts, valid)
    assert where.sum() > 0.5 * valid.sum()
    np.testing.assert_allclose(n[where], [[-1.0, 0.0, 0.0]] * where.sum(),
                               atol=1e-6)


def test_normal_deg_takes_the_worst_sector():
    h, w = 4, 256                    # two sectors of 128 columns
    surface = np.zeros((h, w, 3))
    surface[..., 0] = -1.0
    normal = surface * 0.5           # composited, not normalised
    where = np.ones((h, w), bool)
    assert normal_deg(normal, where, surface, where) < 1e-6
    turned = normal.copy()
    c, s = np.cos(np.radians(60)), np.sin(np.radians(60))
    turned[:, 128:] = 0.5 * np.array([-c, s, 0.0])
    assert abs(normal_deg(turned, where, surface, where) - 60.0) < 1e-6
    assert normal_deg(normal, ~where, surface, where) == np.inf


def _drive(n=60, step=0.7):
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = step * np.arange(n)
    return gt


def test_pose_rpe_m_reads_zero_and_known_offsets():
    gt = _drive()
    assert segment_error(gt, gt, 20.0) == 0.0
    # a 0.25 m jump sideways at frame 30: every segment over it reads it
    est = gt.copy()
    est[30:, 1, 3] += 0.25
    assert segment_error(gt, est, 20.0) == pytest.approx(0.25, abs=1e-12)
    # 1% too far: a segment of 29 sweeps (20.3 m) reads 0.203 m
    est = gt.copy()
    est[:, 0, 3] *= 1.01
    assert segment_error(gt, est, 20.0) == pytest.approx(0.203, abs=1e-12)
    # a drive shorter than a segment has none
    assert segment_error(gt[:20], gt[:20], 20.0) == np.inf


def _gn_problem(h=64, w=1024, seed=7):
    """A sweep of the walk's street at KITTI's field of view, aligned to
    the range image of the one 0.7 m behind it, from a guess 0.2 m
    short: the solve's inputs as the tracker hands them over."""
    from splatloam_tpu_torch.geometry import spherical
    traffic = dict(json.loads((HERE / "workloads/ncd-recon.walk.json")
                              .read_text())["traffic"], beams=h, columns=w,
                   fov_deg=[-24.8, 2.0], step_m=0.7)
    stream = SweepStream(traffic, seed, "cpu")
    f32 = dict(dtype=torch.float32)
    tgt, src = (ri.range_image(stream.sweep(i), h, w, 3.0, 60.0)
                for i in (4, 5))
    depth, K = torch.tensor(tgt[0], **f32), torch.tensor(tgt[2], **f32)
    valid = torch.tensor(tgt[1]) & (depth > 3.0)
    sd, sK = torch.tensor(src[0], **f32), torch.tensor(src[2], **f32)
    src_pts = spherical.depth_to_points(sd, sK).reshape(-1, 3)
    guess = np.eye(4)
    guess[:2, 3] = [0.5, 0.05]
    return guess, (src_pts, torch.tensor(src[1]).reshape(-1), depth,
                   spherical.depth_to_points(depth, K),
                   spherical.depth_to_normal(depth, K), valid, K)


def test_plain_gauss_newton_matches_the_port():
    """The port's float32 solve and the plain float64 one from the same
    inputs and guess land within GN_TOL_M of each other on every valid
    point, and the plain one finds the 0.7 m between the sweeps."""
    from splatloam_tpu_torch.config import Configuration
    from splatloam_tpu_torch.slam.tracker import gauss_newton_align
    guess, inputs = _gn_problem()
    s = gn.settings(Configuration())
    port, _ = gauss_newton_align(
        torch.tensor(guess, dtype=torch.float32), *inputs, 64, 1024,
        num_iterations=s["num_iterations"], huber_delta=s["huber_delta"],
        max_corr_dist=s["max_correspondence_dist"], inlier_threshold=0.3,
        damping=s["damping"], corr_factor_init=s["corr_factor_init"],
        corr_decay_iters=s["corr_decay_iters"],
        convergence_tol=s["convergence_tol"])
    ref = gn.align(guess, *inputs, s)
    assert ref.dtype == torch.float64
    np.testing.assert_allclose(ref[:3, 3].numpy(), [0.7, 0.0, 0.0],
                               atol=0.01)
    assert gn.point_gap(inputs[0], inputs[1], port, ref) <= GN_TOL_M
