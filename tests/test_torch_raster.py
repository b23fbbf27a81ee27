"""The PyTorch port's rasterizer against the JAX package on the CPU.

The port's tiled path runs each CUDA kernel's plain PyTorch version here
(CPU tensors); the JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_raster.py does.  Tolerances are the JAX package's own
kernel tolerances (tests/test_pallas_raster.py): alpha 2e-5, depth and
normal sums 2e-4, dist 3e-4, median 1e-4 where both cross; parameter
gradients 2e-3 * max|g|, pose gradients 3e-3 * max|g|.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloam_tpu.geometry import se3 as jse3
from splatloam_tpu.geometry import spherical as jsph
from splatloam_tpu.ops.rasterizer import RenderParams as JRenderParams
from splatloam_tpu.ops.rasterizer import common as jcommon
from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu.ops.rasterizer.jnp_ref import rasterize_jnp
from splatloam_tpu_torch.ops.rasterizer import common, kernels
from splatloam_tpu_torch.ops.rasterizer.api import RenderParams, rasterize
from splatloam_tpu_torch.ops.rasterizer.cuda_raster import prepare_tiles
from splatloam_tpu_torch.ops.rasterizer.eager_ref import rasterize_eager

H, W = 16, 256
GEO = dict(height=H, width=W, chunk=128, tile_h=8, tile_w=32,
           tile_list_capacity=512)
FWD_TOL = [("alpha", 2e-5), ("depth_sum", 2e-4), ("normal_sum", 2e-4),
           ("dist", 3e-4)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_raster._INTERPRET = True
    yield
    pallas_raster._INTERPRET = False


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.api, "
            "splatloam_tpu_torch.ops.rasterizer.kernels; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _scene(rng, n=300):
    """numpy scene: sensor-facing surfels on a cylinder wall + floor."""
    theta = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-1.0, 1.5, n)
    xyz = np.stack([7 * np.cos(theta), 7 * np.sin(theta), z],
                   -1).astype(np.float32)
    xyz[: n // 3, 2] = -1.4
    xyz[: n // 3, 0] = rng.uniform(-5, 5, n // 3)
    xyz[: n // 3, 1] = rng.uniform(-5, 5, n // 3)
    normals = -xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    quat = np.asarray(jse3.quat_from_normal(jnp.asarray(normals)))
    scales = rng.uniform(0.2, 0.6, (n, 2)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    K = np.asarray(jsph.spherical_intrinsics(jnp.asarray(xyz), H, W)[0])
    return [xyz, scales, quat, opac, np.eye(4, dtype=np.float32), K]


def _posed(scene):
    ang = 0.3
    scene = list(scene)
    scene[4] = np.array([[np.cos(ang), -np.sin(ang), 0, 0.5],
                         [np.sin(ang), np.cos(ang), 0, -0.2],
                         [0, 0, 1, 0.1], [0, 0, 0, 1]], np.float32)
    return scene


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_forward(out, ref):
    for key, tol in FWD_TOL:
        np.testing.assert_allclose(_np(out[key]), _np(ref[key]), atol=tol,
                                   err_msg=key)
    mo, mr = _np(out["median"]), _np(ref["median"])
    both = (mo > 0) & (mr > 0)
    np.testing.assert_allclose(mo[both], mr[both], atol=1e-4)
    assert both.sum() / max((mr > 0).sum(), 1) > 0.99


@pytest.mark.parametrize("posed", [False, True])
def test_forward_parity_vs_pallas(rng, posed):
    scene = _scene(rng)
    if posed:
        scene = _posed(scene)
    ref = pallas_raster.rasterize_pallas(
        *map(jnp.asarray, scene), JRenderParams(backend="pallas", **GEO))
    out = rasterize(*map(torch.tensor, scene),
                    RenderParams(backend="cuda", **GEO))
    _assert_forward(out, ref)
    np.testing.assert_allclose(_np(out["radii"]), _np(ref["radii"]),
                               atol=1e-4)


def _loss(c):
    return (c["depth_sum"].sum() * 0.1 + c["alpha"].sum()
            + 0.5 * c["normal_sum"].sum() + 0.2 * c["dist"].sum())


@pytest.mark.parametrize("scatter", ["ranksum", "rmw"])
def test_gradient_parity_vs_pallas(rng, scatter):
    """Parameter and pose gradients: K2 + K3 (ranksum) or K2 + K4 (rmw)
    plain versions against the Pallas kernels, through pack_surfels."""
    scene = _posed(_scene(rng, n=120))
    jparams = JRenderParams(backend="pallas", scatter=scatter, **GEO)
    jK = jnp.asarray(scene[5])

    def jloss(*a):
        return _loss(pallas_raster.rasterize_pallas(*a, jK, jparams))

    g_ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, scene[:5]))
    leaves = [torch.tensor(a, requires_grad=True) for a in scene[:5]]
    out = rasterize(*leaves, torch.tensor(scene[5]),
                    RenderParams(backend="cuda", scatter=scatter, **GEO))
    g_port = torch.autograd.grad(_loss(out), leaves)
    names = ["xyz", "scales", "quat", "opacity", "T_cw"]
    for name, gp, gr, rel in zip(names, g_port, g_ref, [2e-3] * 4 + [3e-3]):
        gr = np.asarray(gr)
        np.testing.assert_allclose(gp.numpy(), gr,
                                   atol=rel * (np.abs(gr).max() + 1e-6),
                                   err_msg=name)


def test_ranksum_plain_equals_scatter_plain(rng):
    """K3's plain version against K4's on the same backward rows."""
    scene = [torch.tensor(a) for a in _scene(rng)]
    params = RenderParams(backend="cuda", scatter="ranksum", **GEO)
    tiles = prepare_tiles(*scene, params)
    packed = common.pack_surfels(*scene)
    from splatloam_tpu_torch.ops.rasterizer import binning
    F = binning.pack_features(packed)
    kw = dict(chunk=GEO["chunk"], width=W)
    out, tb = kernels.raster_fwd_plain(F, tiles.lists, tiles.counts,
                                       tiles.rays_t, tiles.pix_t,
                                       with_median=True, with_dist=True,
                                       **kw)
    g = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32))
    dFg = kernels.raster_bwd_plain(F, tiles.lists, tiles.counts,
                                   tiles.rays_t, tiles.pix_t, tb, out, g,
                                   with_dist=True, **kw)
    n_rows = F.shape[0]
    dF4 = kernels.scatter_rows_plain(dFg, tiles.lists, tiles.counts, n_rows)
    r_alloc = binning._ranksum_alloc(n_rows, 128)
    dFc = kernels.ranksum_rows_plain(dFg.reshape(-1, 16), tiles.plan.pos,
                                     tiles.plan.ranks,
                                     tiles.plan.rank_of_id[n_rows - 1:],
                                     r_alloc)
    dF3 = dFc[tiles.plan.rank_of_id.long()]
    # the pad row N included: neither reduction adds the padding slots
    np.testing.assert_allclose(dF3.numpy(), dF4.numpy(), atol=1e-5)
    assert float(dF3[-1].abs().max()) == 0.0
    assert float(dF4.abs().max()) > 0


def test_pack_surfels_parity(rng):
    scene = _posed(_scene(rng))
    ref = jcommon.pack_surfels(*map(jnp.asarray, scene))
    out = common.pack_surfels(*map(torch.tensor, scene))
    for name in jcommon.PackedSurfels._fields:
        np.testing.assert_allclose(_np(getattr(out, name)),
                                   _np(getattr(ref, name)), atol=2e-4,
                                   err_msg=name)


def test_eager_vs_jnp(rng):
    """The golden renderers agree: values, and gradients through autograd
    vs XLA autodiff."""
    scene = _posed(_scene(rng, n=150))
    ref = rasterize_jnp(*map(jnp.asarray, scene), H, W)
    out = rasterize_eager(*map(torch.tensor, scene), H, W)
    _assert_forward(out, ref)

    jK = jnp.asarray(scene[5])
    g_ref = jax.grad(lambda *a: _loss(rasterize_jnp(*a, jK, H, W)),
                     argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, scene[:5]))
    leaves = [torch.tensor(a, requires_grad=True) for a in scene[:5]]
    g_port = torch.autograd.grad(
        _loss(rasterize_eager(*leaves, torch.tensor(scene[5]), H, W)),
        leaves)
    for gp, gr, rel in zip(g_port, g_ref, [2e-3] * 4 + [3e-3]):
        gr = np.asarray(gr)
        np.testing.assert_allclose(gp.numpy(), gr,
                                   atol=rel * (np.abs(gr).max() + 1e-6))


def test_unknown_options_raise(rng):
    scene = [torch.tensor(a) for a in _scene(rng, n=20)]
    with pytest.raises(ValueError, match="scatter"):
        rasterize(*scene, RenderParams(backend="cuda", scatter="bogus",
                                       **GEO))
    # the flat layout renders (tests/test_torch_flat.py holds it to JAX)
    flat = rasterize(*scene, RenderParams(backend="cuda", layout="flat",
                                          **GEO))
    assert flat["alpha"].shape == (H, W)
    assert bool(torch.isfinite(flat["alpha"]).all())
    with pytest.raises(ValueError, match="layout"):
        rasterize(*scene, RenderParams(backend="cuda", layout="bogus",
                                       **GEO))
    with pytest.raises(ValueError, match="backend"):
        rasterize(*scene, RenderParams(backend="pallas", **GEO))
