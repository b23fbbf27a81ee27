"""Tracking of the PyTorch port against the JAX package on the same numpy
inputs: the se(3) exponential, ``gauss_newton_align`` on every fixture of
tests/test_tracker.py at 24x256 (T within 1e-4, fitness within 1e-3),
``AlignerGN`` end to end on one shared pool (the JAX target rendered by
its jnp golden renderer, the port's by the tiled path, whose forward K1
runs its plain version on the CPU), and the ``Preprocessor``.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import synthetic
import torch

from splatloam_tpu import config as jconfig
from splatloam_tpu import preprocessing as jpre
from splatloam_tpu.geometry import se3 as jse3
from splatloam_tpu.geometry import spherical as jsph
from splatloam_tpu.model import surfels as JS
from splatloam_tpu.model.local_model import LocalModel as JLocalModel
from splatloam_tpu.ops import projection as jproj
from splatloam_tpu.slam import tracker as jtracker
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch import preprocessing
from splatloam_tpu_torch.convert import surfels_from_numpy
from splatloam_tpu_torch.geometry import se3
from splatloam_tpu_torch.model.local_model import LocalModel
from splatloam_tpu_torch.ops.rasterizer.api import render
from splatloam_tpu_torch.slam import tracker

H, W = 24, 256
T_ATOL, FIT_ATOL = 1e-4, 1e-3
GN = dict(huber_delta=0.3, max_corr_dist=1.0, inlier_threshold=0.3,
          damping=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths run thousands of small ops; beside the other
    workers of a parallel test run, torch's intra-op thread pool would
    oversubscribe the cores and wait in its barriers.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.slam, "
            "splatloam_tpu_torch.slam.tracker, "
            "splatloam_tpu_torch.preprocessing, "
            "splatloam_tpu_torch.checkpoint, splatloam_tpu_torch.debug, "
            "splatloam_tpu_torch.postprocessing, "
            "splatloam_tpu_torch.logging_backends, splatloam_tpu_torch.io; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_entry_points_need_a_gpu_or_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    cfg = pconfig.Configuration()
    for make in (tracker.Tracker, preprocessing.Preprocessor):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)


def test_exp_se3(rng):
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    # rotation angles on both sides of the Taylor branch, and zero
    xi[0, 3:] = 0.0
    xi[1, 3:] = [3e-6, -2e-6, 1e-6]
    xi[2, 3:] = [1e-5, 0.0, 0.0]
    xi[3, 3:] = [2e-5, 0.0, 0.0]
    xi[4] = 0.0
    np.testing.assert_allclose(se3.hat(torch.tensor(xi[:, 3:])).numpy(),
                               np.asarray(jse3.hat(jnp.asarray(xi[:, 3:]))),
                               atol=1e-6)
    port = se3.exp_se3(torch.tensor(xi)).numpy()
    ref = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    np.testing.assert_allclose(port, ref, atol=1e-6)
    assert np.all(np.isfinite(port))


# ---------------------------------------------------------------------------
# gauss_newton_align on the fixtures of tests/test_tracker.py
# ---------------------------------------------------------------------------

def _frame_images(rng, pose):
    cloud = synthetic.sensor_cloud(rng, pose)
    K, _, _ = jsph.spherical_intrinsics(jnp.asarray(cloud), H, W)
    depth, _, valid = jproj.build_range_image(
        jnp.asarray(cloud), jnp.ones(len(cloud), bool), K, H, W, 0.5, 30.0)
    return K, depth, valid


def _yaw_pose(ang, t):
    T = np.eye(4)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                 [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def _fixture(name):
    """(arrays, options) of one test_tracker.py case: arrays are the GN
    inputs (T_init, src_pts, src_valid, tgt depth, points, normals, valid,
    K) as numpy."""
    rng = np.random.default_rng(0)
    K, depth_t, valid_t = _frame_images(rng, np.eye(4))
    pts_t = jsph.depth_to_points(depth_t, K)
    normals_t = jsph.depth_to_normal(depth_t, K)
    src_pts = pts_t.reshape(-1, 3)
    src_valid = np.asarray(valid_t).reshape(-1)
    opts = dict(num_iterations=30, **GN)
    if name in ("small", "range", "basin"):
        pose = {"small": _yaw_pose(0.03, [0.2, -0.1, 0.05]),
                "range": _yaw_pose(0.0, [0.15, -0.1, 0.05]),
                "basin": _yaw_pose(0.1, [0.6, -0.3, 0.1])}[name]
        K_s, depth_s, valid_s = _frame_images(rng, pose)
        src_pts = jsph.depth_to_points(depth_s, K_s).reshape(-1, 3)
        src_valid = np.asarray(valid_s).reshape(-1)
    if name == "range":
        opts["lambda_range"] = 0.5
    elif name == "basin":
        opts.update(num_iterations=60, corr_factor_init=3.0,
                    corr_decay_iters=20, convergence_tol=1e-6)
    elif name == "exit":
        opts.update(num_iterations=50, convergence_tol=1e-5)
    elif name == "identity":
        opts["num_iterations"] = 10
    elif name == "few_valid":
        # 5 valid source points: every solve fails, T stays the guess
        keep = np.flatnonzero(src_valid)[:5]
        src_valid = np.zeros_like(src_valid)
        src_valid[keep] = True
        opts["num_iterations"] = 5
    T0 = _yaw_pose(0.01, [0.05, 0.0, 0.0]) if name == "few_valid" \
        else np.eye(4)
    arrays = [T0.astype(np.float32), src_pts, src_valid, depth_t, pts_t,
              normals_t, valid_t, K]
    return [np.asarray(a) for a in arrays], opts


@pytest.mark.parametrize("name", ["small", "range", "basin", "exit",
                                  "identity", "few_valid"])
def test_gauss_newton_align_matches_jax(name):
    arrays, opts = _fixture(name)
    jT, jfit = jtracker.gauss_newton_align(
        *(jnp.asarray(a) for a in arrays), height=H, width=W, **opts)
    pT, pfit = tracker.gauss_newton_align(
        *(torch.tensor(a) for a in arrays), height=H, width=W, **opts)
    np.testing.assert_allclose(pT.numpy(), np.asarray(jT), atol=T_ATOL)
    assert abs(float(pfit) - float(jfit)) <= FIT_ATOL
    if name == "few_valid":
        np.testing.assert_array_equal(pT.numpy(), arrays[0])
    if name == "exit":
        # the early exit took effect: the answer differs from running all
        # 50 iterations only by the steps below the tolerance
        full = dict(opts, convergence_tol=0.0)
        pT_full, _ = tracker.gauss_newton_align(
            *(torch.tensor(a) for a in arrays), height=H, width=W, **full)
        np.testing.assert_allclose(pT.numpy(), pT_full.numpy(), atol=1e-4)


def test_no_correspondences_leave_the_guess():
    """An empty target: every solve fails (dx = 0, |dx| = inf), and a
    singular H reads as a failed solve instead of raising."""
    K = np.array([[10.0, 0, 31.0], [0, -3.0, 3.0], [0, 0, 1]], np.float32)
    args = [np.eye(4, dtype=np.float32), np.ones((128, 3), np.float32),
            np.ones(128, bool), np.zeros((8, 64), np.float32),
            np.zeros((8, 64, 3), np.float32),
            np.zeros((8, 64, 3), np.float32), np.zeros((8, 64), bool), K]
    pT, pfit = tracker.gauss_newton_align(
        *(torch.tensor(a) for a in args), height=8, width=64,
        num_iterations=5, **dict(GN, damping=0.0))
    np.testing.assert_array_equal(pT.numpy(), np.eye(4))
    assert float(pfit) == 0.0


# ---------------------------------------------------------------------------
# AlignerGN end to end on a shared pool
# ---------------------------------------------------------------------------

CAP = 8192


def _cfg_dict():
    return {
        "preprocessing": {"image_height": H, "image_width": W,
                          "depth_min": 0.5, "depth_max": 30.0},
        "tracking": {"method": "gsaligner"},
        "compute": {"initial_capacity": CAP},
        "logging": {"enable": False},
    }


def _cfgs():
    j = _cfg_dict()
    j["compute"]["backend"] = "jnp"
    p = _cfg_dict()
    p["compute"]["backend"] = "cuda"
    return (jconfig.from_dict(jconfig.Configuration, j),
            pconfig.from_dict(pconfig.Configuration, p))


def _frames(rng, poses):
    """JAX and port frames of the same preprocessed clouds."""
    from splatloam_tpu.model.camera import make_camera as jcam
    from splatloam_tpu.model.frame import Frame as JFrame
    from splatloam_tpu_torch.model.camera import make_camera
    from splatloam_tpu_torch.model.frame import Frame
    out = []
    for i, pose in enumerate(poses):
        pts = synthetic.sensor_cloud(rng, pose)
        arrs = [np.asarray(a) for a in jpre._preprocess_device(
            jnp.asarray(pts), jnp.ones(len(pts), bool), H, W, 0.5, 30.0)]
        out.append((JFrame(jcam(*arrs), i, world_T_frame=pose),
                    Frame(make_camera(*arrs, device="cpu"), i,
                          world_T_frame=pose)))
    return out


def test_aligner_gn_on_a_shared_pool():
    rng = np.random.default_rng(0)
    jcfg, pcfg = _cfgs()
    (jkf, pkf), (jfr, pfr) = _frames(
        rng, [np.eye(4), _yaw_pose(0.02, [0.3, -0.1, 0.0])])
    # the pool: one surfel per valid keyframe pixel (JAX's initializer)
    cam = jkf.camera
    valid = np.asarray(cam.valid)
    xyz = np.asarray(jsph.depth_to_points(cam.depth, cam.K))[valid]
    nrm = np.asarray(cam.normal)[valid]
    js, jadam = JS.create_from_cloud(jnp.asarray(xyz), jnp.asarray(nrm),
                                     capacity=CAP)
    jlm = JLocalModel(jcfg)
    jlm.surfels, jlm.adam = js, jadam
    jlm.insert_keyframe(jkf)
    plm = LocalModel(pcfg, device="cpu")
    plm.surfels, plm.adam = surfels_from_numpy(
        {k: np.asarray(getattr(js.params, k))
         for k in JS.SurfelParams._fields}, np.asarray(js.active), None,
        device="cpu")
    plm.insert_keyframe(pkf)

    ja = jtracker.AlignerGN(jcfg)
    pa = tracker.AlignerGN(pcfg, device="cpu")
    ja.set_model(jlm)
    pa.set_model(plm)
    ja.set_target(jkf)
    pa.set_target(pkf)
    jd, _, _, jv = (np.asarray(a) for a in ja._target[:4])
    pd, _, _, pv = (a.numpy() for a in pa._target[:4])
    assert jv.sum() > 0.5 * valid.sum()
    np.testing.assert_allclose(pd, jd, atol=2e-4)
    # valid may differ only where alpha or depth sits at its threshold
    kcam = pkf.camera_in_model()
    s = plm.surfels
    with torch.no_grad():
        alpha = render(s.params.xyz, s.scaling, s.rotation, s.opacity,
                       kcam.T_cw, kcam.K, pa._params_for(kcam))["rend_alpha"]
    tie = (np.abs(alpha.numpy() - 0.5) < 1e-5) | \
        (np.abs(jd - jcfg.preprocessing.depth_min) < 1e-5)
    np.testing.assert_array_equal(pv[~tie], jv[~tie])

    ja.set_source(jfr)
    pa.set_source(pfr)
    jT = ja.align(np.eye(4))
    pT = pa.align(np.eye(4))
    assert pT.dtype == np.float64 and pT.shape == (4, 4)
    np.testing.assert_allclose(pT, jT, atol=T_ATOL)
    assert abs(pa.fitness() - ja.fitness()) <= FIT_ATOL
    assert pa.fitness() > 0.5


# ---------------------------------------------------------------------------
# Preprocessor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normals,ground", [(False, False), (True, False),
                                            (False, True)])
def test_preprocessor_matches_jax(rng, normals, ground):
    d = {"preprocessing": {"image_height": 16, "image_width": 128,
                           "depth_min": 0.5, "depth_max": 30.0,
                           "enable_normal_estimation": normals,
                           "enable_ground_segmentation": ground},
         "logging": {"enable": False}}
    pose = _yaw_pose(0.1, [0.4, 0.2, 0.0])
    cloud = synthetic.sensor_cloud(rng, pose, n=6000)
    cloud[:3] = np.nan                       # dropped by both
    jf = jpre.Preprocessor(jconfig.from_dict(jconfig.Configuration, d))(
        cloud, 0.5, gt_pose=pose)
    pf = preprocessing.Preprocessor(
        pconfig.from_dict(pconfig.Configuration, d), device="cpu")(
        cloud, 0.5, gt_pose=pose)
    assert pf.timestamp == jf.timestamp
    np.testing.assert_array_equal(pf.world_T_frame, jf.world_T_frame)
    jc, pc = jf.camera, pf.camera
    np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(jc.valid))
    for name in ("K", "depth", "normal"):
        np.testing.assert_allclose(getattr(pc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-6,
                                   err_msg=name)
    assert pc.valid.sum() > 0
