"""Geometry, projection, KNN and device preprocessing of the PyTorch port
against the JAX package on the same numpy inputs (atol 1e-5; integer
outputs exactly)."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import synthetic
import torch

from splatloam_tpu import preprocessing as jpre
from splatloam_tpu.geometry import se3 as jse3
from splatloam_tpu.geometry import spherical as jsph
from splatloam_tpu.ops import knn as jknn
from splatloam_tpu.ops import projection as jproj
from splatloam_tpu_torch import preprocessing
from splatloam_tpu_torch.geometry import se3, spherical
from splatloam_tpu_torch.ops import knn, projection

ATOL = 1e-5


def test_port_and_chip_smoke_import_no_jax():
    code = ("import sys, splatloam_tpu_torch, splatloam_tpu_torch.convert, "
            "splatloam_tpu_torch.slam.mapper, "
            "splatloam_tpu_torch.ops.rasterizer.cuda_raster, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = [1, 0, 0, 0]
    q[1] = [0, 1, 0, 0]            # 180 degree turn: a near-singular case
    return q


def _pose(rng):
    R = np.asarray(jse3.quat_to_rotmat(jnp.asarray(_quats(rng, 3)[2])))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3)
    return T


@pytest.mark.parametrize("fn", ["quat_to_rotmat", "standardize_quat",
                                "quat_roundtrip"])
def test_quaternions(rng, fn):
    q = _quats(rng)
    if fn == "quat_roundtrip":
        R = np.asarray(jse3.quat_to_rotmat(jnp.asarray(q)))
        _close(se3.rotmat_to_quat(torch.tensor(R)),
               jse3.rotmat_to_quat(jnp.asarray(R)))
    else:
        _close(getattr(se3, fn)(torch.tensor(q)),
               getattr(jse3, fn)(jnp.asarray(q)))


def test_normal_bases(rng):
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n[0] = [1, 0, 0]               # collinear with the seed axis
    n[1] = [-1, 1e-4, 0]
    _close(se3.basis_from_normal(torch.tensor(n)),
           jse3.basis_from_normal(jnp.asarray(n)))
    _close(se3.quat_from_normal(torch.tensor(n)),
           jse3.quat_from_normal(jnp.asarray(n)))


def test_rigid_transforms(rng):
    T = _pose(rng)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    _close(se3.invert_T(torch.tensor(T)), jse3.invert_T(jnp.asarray(T)))
    _close(se3.transform_points(torch.tensor(T), torch.tensor(pts)),
           jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)))


def _cloud(rng, n=3000):
    return synthetic.sensor_cloud(rng, np.eye(4), n=n)


def test_spherical_camera(rng):
    pts = _cloud(rng)
    h, w = 16, 128
    jK, jv, jh = jsph.spherical_intrinsics(jnp.asarray(pts), h, w)
    K, v, hf = spherical.spherical_intrinsics(torch.tensor(pts), h, w)
    _close(K, jK)
    _close(v, jv)
    for a, b in zip(spherical.project_points(K, torch.tensor(pts)),
                    jsph.project_points(jK, jnp.asarray(pts))):
        _close(a, b, atol=1e-4)     # pixel coordinates up to ~128
    _close(spherical.pixel_rays(K, h, w), jsph.pixel_rays(jK, h, w))


def test_depth_images(rng):
    h, w = 16, 64
    K = np.asarray(jsph.spherical_intrinsics(jnp.asarray(_cloud(rng)),
                                             h, w)[0])
    depth = rng.uniform(2.0, 20.0, (h, w)).astype(np.float32)
    depth[3:5, 10:20] = 0.0         # holes -> degenerate normals
    valid = depth > 0
    T = _pose(rng)
    tK, td, tT = torch.tensor(K), torch.tensor(depth), torch.tensor(T)
    jK, jd, jT = jnp.asarray(K), jnp.asarray(depth), jnp.asarray(T)
    _close(spherical.depth_to_points(td, tK, tT),
           jsph.depth_to_points(jd, jK, jT), atol=1e-4)
    _close(spherical.depth_to_normal(td, tK, tT),
           jsph.depth_to_normal(jd, jK, jT), atol=1e-4)
    _close(spherical.depth_gradient(td, torch.tensor(valid)),
           jsph.depth_gradient(jd, jnp.asarray(valid)))


def test_range_image_and_preprocess(rng):
    pts = _cloud(rng, 6000)
    mask = np.ones(len(pts), bool)
    mask[-100:] = False             # padding rows
    h, w = 16, 128
    K = jsph.spherical_intrinsics(jnp.asarray(pts), h, w)[0]
    jd, jl, jv = jproj.build_range_image(jnp.asarray(pts),
                                         jnp.asarray(mask), K, h, w,
                                         0.5, 30.0)
    td, tl, tv = projection.build_range_image(
        torch.tensor(pts), torch.tensor(mask),
        torch.tensor(np.asarray(K)), h, w, 0.5, 30.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(td, jd)

    jout = jpre._preprocess_device(jnp.asarray(pts), jnp.asarray(mask),
                                   h, w, 0.5, 30.0)
    tout = preprocessing._preprocess_device(torch.tensor(pts),
                                            torch.tensor(mask), h, w,
                                            0.5, 30.0)
    for a, b in zip(tout, jout):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b)


def test_knn(rng):
    pts = _cloud(rng, 500)
    mask = rng.uniform(size=len(pts)) < 0.9
    tp, tm = torch.tensor(pts), torch.tensor(mask)
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    np.testing.assert_array_equal(knn.morton_codes(tp, tm).numpy(),
                                  np.asarray(jknn.morton_codes(jp, jm)))
    _close(knn.mean_sq_dist_knn(tp, tm), jknn.mean_sq_dist_knn(jp, jm))
    _close(knn.mean_sq_dist_knn(tp), jknn.mean_sq_dist_knn(jp))
    _close(knn.mean_sq_dist_knn_exact(tp[:200], tm[:200]),
           jknn.mean_sq_dist_knn_exact(jp[:200], jm[:200]))
