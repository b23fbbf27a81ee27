"""The port's evaluation and meshing numerics (splatloam_tpu_torch.eval)
on the CPU: the JAX package's recon, TSDF and Poisson tests
(tests/test_eval.py, test_eval_crossval.py, test_poisson.py; 13 tests,
closed-form fixtures) run against the port's copies, then the port's
``fuse_points_tsdf``, ``marching_cubes``, ``poisson_grid``,
``evaluate_recon`` and ``crop_union`` held to the JAX package's on the
same seeded inputs.

Tolerances: the TSDF grid within 1e-5 m (the float32 sums of
``index_add_`` land in another order than JAX's scatter-add; the signed
distances are bounded by the 0.45 m truncation), with an equal NaN
(unobserved) mask; marching tetrahedra, the grid Poisson solver,
``evaluate_recon`` and ``crop_union`` equal on the same input (host
numpy and scipy in both packages).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from splatloam_tpu.eval import recon as jrecon
from splatloam_tpu.eval import tsdf as jtsdf
from splatloam_tpu_torch.eval.odometry import evaluate_rpe
from splatloam_tpu_torch.eval.recon import (crop_union, evaluate_recon,
                                            load_mesh, sample_mesh_uniform,
                                            voxel_downsample)
from splatloam_tpu_torch.eval.tsdf import (fuse_points_tsdf, marching_cubes,
                                           poisson_grid, save_mesh_ply)
from splatloam_tpu_torch.io.ply import write_ply
from test_eval import _circle_trajectory
from test_eval_crossval import _line_trajectory, _plane_cloud, _plane_mesh
from test_poisson import _cylinder_samples

CPU = "cpu"
TSDF_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other workers of a parallel test run, torch's intra-op
    thread pool would oversubscribe the cores.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.eval, "
            "splatloam_tpu_torch.eval.recon, splatloam_tpu_torch.eval.tsdf; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_fusion_needs_a_gpu_or_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fuse_points_tsdf(pts, np.ones_like(pts), 0.5, 1.0)


# ---------------------------------------------------------------------------
# tests/test_eval.py
# ---------------------------------------------------------------------------

def test_rpe_zero_for_identical():
    poses = _circle_trajectory()
    ts = [0.1 * i for i in range(len(poses))]
    mean, std = evaluate_rpe(poses, poses, ts, ts)
    assert mean < 1e-9 and std < 1e-9


def test_rpe_detects_drift():
    poses = _circle_trajectory()
    ts = [0.1 * i for i in range(len(poses))]
    drifted = []
    for i, p in enumerate(poses):
        q = p.copy()
        q[:3, 3] = q[:3, 3] + np.array([5e-3 * i, 0, 0])
        drifted.append(q)
    mean, _ = evaluate_rpe(drifted, poses, ts, ts)
    assert 1e-4 < mean < 0.2
    drifted2 = [p.copy() for p in drifted]
    for i, q in enumerate(drifted2):
        q[:3, 3] = q[:3, 3] + np.array([0, 2e-2 * i, 0])
    mean2, _ = evaluate_rpe(drifted2, poses, ts, ts)
    assert mean2 > mean


def _sphere(rng, n=20000):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return 2.0 * d, d


def test_tsdf_mesh_sphere(tmp_path, rng):
    pts, normals = _sphere(rng)
    tsdf, origin = fuse_points_tsdf(pts, normals, voxel_size=0.15,
                                    trunc=0.45, device=CPU)
    verts, faces = marching_cubes(tsdf, origin, 0.15)
    assert len(verts) > 200 and len(faces) > 200
    radii = np.linalg.norm(verts, axis=1)
    assert abs(np.median(radii) - 2.0) < 0.08
    mesh_path = tmp_path / "sphere.ply"
    save_mesh_ply(mesh_path, verts, faces)
    v2, f2 = load_mesh(mesh_path)
    assert len(v2) == len(verts) and len(f2) == len(faces)

    ref_path = tmp_path / "ref.ply"
    write_ply(ref_path, {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
    metrics = evaluate_recon(ref_path, mesh_path, down_sample_res=0.05,
                             mesh_sample_point=50000)
    assert metrics["Chamfer_L1 (cm)"] < 10.0
    assert metrics["F-score (%)"] > 90.0


def test_mesh_sampling_and_downsample():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    faces = np.array([[0, 1, 2]])
    pts = sample_mesh_uniform(verts, faces, 5000)
    assert np.all(pts[:, 2] == 0)
    assert np.all(pts[:, 0] >= -1e-9) and np.all(pts[:, 1] >= -1e-9)
    assert np.all(pts[:, 0] + pts[:, 1] <= 1 + 1e-9)
    down = voxel_downsample(pts, 0.2)
    assert len(down) < 40


def test_associate_trajectories_tum_semantics():
    from splatloam_tpu_torch.eval.odometry import associate_trajectories

    def pose(x):
        T = np.eye(4)
        T[0, 3] = x
        return T

    ref, est = associate_trajectories(
        [0.0, 0.10, 0.20], [pose(10 + i) for i in range(3)], [0.09, 0.10],
        [pose(20 + i) for i in range(2)], max_diff=0.05)
    assert len(ref) == 1
    assert ref[0][0, 3] == 11 and est[0][0, 3] == 21
    ref, est = associate_trajectories(
        [0.0, 0.1, 0.2, 0.3], [pose(i) for i in range(4)],
        [0.102, 0.1, 0.3, 0.299], [pose(10 + i) for i in range(4)],
        max_diff=0.05)
    got = sorted((e[0, 3], r[0, 3]) for r, e in zip(ref, est))
    assert got == [(11.0, 1.0), (12.0, 3.0)]


# ---------------------------------------------------------------------------
# tests/test_eval_crossval.py
# ---------------------------------------------------------------------------

def test_rpe_linear_scale_drift_closed_form():
    """est = (1+a) * gt positions, identity rotations: every pair's error
    is a * path(i,j), and path(i,j) in [0.9, 1.1] * delta by the 10%
    window, so the delta-normalized mean MUST lie in [0.9a, 1.1a] and the
    std below 0.2a/sqrt(12)-ish.  (evo's rpe point_distance with
    all_pairs + delta normalization obeys the same closed form.)"""
    a = 0.02
    gt = _line_trajectory()
    est = []
    for p in gt:
        q = p.copy()
        q[:3, 3] = q[:3, 3] * (1.0 + a)
        est.append(q)
    mean, std = evaluate_rpe(est, gt, is_kitti=True)
    assert 0.9 * a <= mean <= 1.1 * a, mean
    assert std <= 0.1 * a, std


def test_rpe_rotation_sensitivity_closed_form():
    """est translations equal gt but every est pose rotated by yaw b:
    the point_distance relation gives |Rz(b)^T d - d| = 2 sin(b/2) |d|
    per pair, so mean/delta in [0.9, 1.1] * 2 sin(b/2)."""
    b = 0.05
    gt = _line_trajectory()
    Rz = np.array([[np.cos(b), -np.sin(b), 0],
                   [np.sin(b), np.cos(b), 0], [0, 0, 1]])
    est = []
    for p in gt:
        q = p.copy()
        q[:3, :3] = Rz
        est.append(q)
    expected = 2 * np.sin(b / 2)
    mean, _ = evaluate_rpe(est, gt, is_kitti=True)
    assert 0.9 * expected <= mean <= 1.1 * expected, (mean, expected)


def _recon(tmp_path, ref, est_v, est_f, **kw):
    ref_file = tmp_path / "ref.ply"
    est_file = tmp_path / "est.ply"
    save_mesh_ply(ref_file, ref, np.empty((0, 3), np.int64))
    save_mesh_ply(est_file, est_v, est_f)
    return evaluate_recon(ref_file, est_file, down_sample_res=0.0,
                          gt_bbox_mask_on=False, **kw)


def test_recon_offset_plane_closed_form(tmp_path):
    d = 0.1
    r = _recon(tmp_path, _plane_cloud(0.0, spacing=0.01), *_plane_mesh(d),
               mesh_sample_point=200_000)
    assert abs(r["MAE_accuracy (cm)"] - d * 100) < 0.1, r
    assert abs(r["MAE_completeness (cm)"] - d * 100) < 0.1, r
    assert abs(r["Chamfer_L1 (cm)"] - d * 100) < 0.1, r
    assert r["Precision [Accuracy] (%)"] == 100.0
    assert r["Recall [Completeness] (%)"] == 100.0
    assert abs(r["F-score (%)"] - 100.0) < 1e-9


def test_recon_offset_beyond_threshold(tmp_path):
    d = 0.3
    r = _recon(tmp_path, _plane_cloud(0.0, spacing=0.01), *_plane_mesh(d),
               mesh_sample_point=200_000)
    assert abs(r["MAE_accuracy (cm)"] - d * 100) < 0.1, r
    assert r["Precision [Accuracy] (%)"] == 0.0
    assert r["F-score (%)"] == 0.0


def test_recon_truncation_caps_completeness(tmp_path):
    r = _recon(tmp_path, _plane_cloud(0.0, spacing=0.05), *_plane_mesh(1.0),
               mesh_sample_point=100_000)
    assert abs(r["MAE_completeness (cm)"] - 50.0) < 1e-6, r
    assert np.isnan(r["MAE_accuracy (cm)"])


# ---------------------------------------------------------------------------
# tests/test_poisson.py
# ---------------------------------------------------------------------------

def test_poisson_grid_cylinder_accuracy(rng):
    pts, nrm = _cylinder_samples(rng)
    voxel = 0.15
    verts, faces = poisson_grid(pts, nrm, voxel_size=voxel)
    assert len(verts) > 500 and len(faces) > 500
    err = np.abs(np.linalg.norm(verts[:, :2], axis=1) - 4.0)
    assert np.median(err) < voxel, np.median(err)
    assert np.quantile(err, 0.95) < 2 * voxel
    d, _ = cKDTree(verts).query(pts[::50], k=1)
    assert np.quantile(d, 0.95) < 2 * voxel
    d2, _ = cKDTree(pts).query(verts, k=1)
    assert d2.max() < 6 * voxel, d2.max()


def test_poisson_grid_open_plane(rng):
    n = 20_000
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                    np.zeros(n)], -1).astype(np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
    verts, faces = poisson_grid(pts, nrm, voxel_size=0.2)
    assert len(verts) > 200
    assert np.quantile(np.abs(verts[:, 2]), 0.95) < 0.2
    assert np.abs(verts[:, :2]).max() < 3.0 + 1.0


def test_poisson_grid_empty():
    v, f = poisson_grid(np.zeros((0, 3)), np.zeros((0, 3)), 0.2)
    assert len(v) == 0 and len(f) == 0


# ---------------------------------------------------------------------------
# the port against the JAX package on the same inputs
# ---------------------------------------------------------------------------

def test_fuse_points_tsdf_matches_jax(rng):
    pts, normals = _sphere(rng)
    pts = pts + rng.normal(0, 0.01, pts.shape)
    tsdf, origin = fuse_points_tsdf(pts, normals, 0.15, 0.45, device=CPU)
    jt, jo = jtsdf.fuse_points_tsdf(pts, normals, 0.15, 0.45)
    np.testing.assert_array_equal(origin, jo)
    assert tsdf.shape == jt.shape and tsdf.dtype == jt.dtype
    np.testing.assert_array_equal(np.isnan(tsdf), np.isnan(jt))
    obs = ~np.isnan(jt)
    assert obs.sum() > 1000
    np.testing.assert_allclose(tsdf[obs], jt[obs], atol=TSDF_ATOL)
    # one grid through both triangulations: the same mesh
    for got, ref in zip(marching_cubes(jt, jo, 0.15),
                        jtsdf.marching_cubes(jt, jo, 0.15)):
        np.testing.assert_array_equal(got, ref)


def test_fuse_points_tsdf_voxel_budget():
    pts = np.array([[0, 0, 0], [100, 100, 100]], np.float32)
    with pytest.raises(ValueError, match="exceeds"):
        fuse_points_tsdf(pts, np.ones_like(pts), 0.1, 0.3, device=CPU)


def test_poisson_grid_matches_jax(rng):
    pts, nrm = _cylinder_samples(rng, n=8000)
    for screen in (0.0, 3.0):
        got = poisson_grid(pts, nrm, voxel_size=0.2, screen_voxels=screen)
        ref = jtsdf.poisson_grid(pts, nrm, voxel_size=0.2,
                                 screen_voxels=screen)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_recon_and_crop_match_jax(tmp_path, rng):
    """evaluate_recon (with the error map) and crop_union: the same
    metrics, map and cropped cloud as the JAX package's."""
    pts, normals = _sphere(rng, n=5000)
    tsdf, origin = jtsdf.fuse_points_tsdf(pts, normals, 0.2, 0.6)
    mesh = tmp_path / "est.ply"
    save_mesh_ply(mesh, *marching_cubes(tsdf, origin, 0.2))
    ref = tmp_path / "ref.ply"
    write_ply(ref, {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
    kw = dict(down_sample_res=0.05, mesh_sample_point=20_000,
              generate_error_map=True)
    got = evaluate_recon(ref, mesh, error_map_filename=tmp_path / "p.ply",
                         **kw)
    want = jrecon.evaluate_recon(ref, mesh,
                                 error_map_filename=tmp_path / "j.ply", **kw)
    assert got == want
    assert (tmp_path / "p.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(
        crop_union(ref, [mesh], threshold_dist=0.1, mesh_sample_point=5000),
        jrecon.crop_union(ref, [mesh], threshold_dist=0.1,
                          mesh_sample_point=5000))
