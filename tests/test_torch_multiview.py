"""The port's multi-view path against the JAX package on the CPU:
``render_batch`` / ``rasterize_cuda_batched`` over B = 3 views of one
surfel set under each gradient reduction, the ``scatter_tps`` reduction
(K10), and the mapper with ``views_per_iteration = 3``.

The JAX side runs its Pallas kernels in interpret mode, and its mapper
through the jnp golden renderer.  Tolerances are the repo's
(tests/test_pallas_raster.py): alpha 2e-5, depth and normal sums 2e-4,
dist 3e-4; gradients 2e-3 * max|g|, pose gradients 3e-3 * max|g|; the same
sums in another order 1e-5 * max(1, max|g|).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flat import (_assert_grads, _grads_port,
                             _jax_channels_and_grads, _views)
from test_torch_mapper import (CAP, EMA_RTOL, _assert_pools, _cfgs,
                               _densified, _lrs, _port_pool, frames)
from test_torch_mapper import H as MH
from test_torch_mapper import W as MW
from test_torch_raster import _scene

from splatloam_tpu.geometry import spherical as jsph
from splatloam_tpu.model.local_model import LocalModel as JLocalModel
from splatloam_tpu.ops.rasterizer import RenderParams as JRenderParams
from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu.slam import mapper as jmapper
from splatloam_tpu_torch.model.local_model import LocalModel
from splatloam_tpu_torch.ops.rasterizer import cuda_raster, kernels
from splatloam_tpu_torch.ops.rasterizer.api import (RenderParams,
                                                    render_batch)
from splatloam_tpu_torch.slam import mapper

assert frames        # a module fixture of test_torch_mapper, used below
B = 3
# 16x128 images, 8 tiles of 8x32 per view, two chunks of 128 per tile
PARAMS = dict(height=16, width=128, chunk=128, tile_h=8, tile_w=32,
              tile_list_capacity=256, with_median=False)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_raster, "_INTERPRET", True)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.cuda_raster, "
            "splatloam_tpu_torch.ops.rasterizer.api, "
            "splatloam_tpu_torch.slam.mapper; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _scene_views(rng):
    """B posed views of one 150-surfel scene at the PARAMS image size."""
    scene = _scene(rng, n=150)
    scene[5] = np.asarray(jsph.spherical_intrinsics(
        jnp.asarray(scene[0]), PARAMS["height"], PARAMS["width"])[0])
    return _views(scene, B)


@pytest.mark.parametrize("scatter", ["rmw", "ranksum", "fused", "plan"])
def test_render_batch_vs_jax(rng, scatter):
    """B = 3 views in one pass: channels and gradients (summed over the
    views for the surfels, per view for the poses) against JAX
    rasterize_pallas_batched with the same reduction; render_batch decodes
    the same channels."""
    scene = _scene_views(rng)
    jp = JRenderParams(backend="pallas", scatter=scatter, **PARAMS)
    tp = RenderParams(backend="cuda", scatter=scatter, **PARAMS)
    jK, tK = jnp.asarray(scene[5]), torch.tensor(scene[5])
    ref, g_ref = _jax_channels_and_grads(
        lambda *a: pallas_raster.rasterize_pallas_batched(*a, jK, jp), scene)
    tscene = [torch.tensor(a) for a in scene]
    out = cuda_raster.rasterize_cuda_batched(*tscene, tp)
    for key, tol in [("alpha", 2e-5), ("depth_sum", 2e-4),
                     ("normal_sum", 2e-4), ("dist", 3e-4)]:
        assert out[key].shape[0] == B
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=tol, err_msg=key)
    _assert_grads(_grads_port(
        lambda *a: cuda_raster.rasterize_cuda_batched(*a, tK, tp), scene),
        g_ref, scatter)
    pkg = render_batch(*tscene, tp)
    np.testing.assert_array_equal(pkg["rend_alpha"].numpy(),
                                  out["alpha"].numpy())


@pytest.mark.parametrize("tps,used", [(4, 4), (5, 2)])
def test_scatter_tps_matches_one(rng, monkeypatch, tps, used):
    """scatter="rmw" with scatter_tps > 1 reduces through K10 with tps
    cut to a divisor of the B*T tiles (24 here), and gives K4's sums."""
    calls = []
    k10 = kernels.scatter_rows_tps

    def spy(*a, **kw):
        calls.append(a[-1])
        return k10(*a, **kw)

    monkeypatch.setattr(kernels, "scatter_rows_tps", spy)
    scene = _scene_views(rng)
    tK = torch.tensor(scene[5])
    grads = {}
    for t in (1, tps):
        tp = RenderParams(backend="cuda", scatter="rmw", scatter_tps=t,
                          **PARAMS)
        grads[t] = _grads_port(
            lambda *a: cuda_raster.rasterize_cuda_batched(*a, tK, tp), scene)
    assert calls == [used]
    for name, a, b in zip(["xyz", "scales", "quat", "opacity", "T_cw"],
                          grads[tps], grads[1]):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), atol=1e-5 * max(1.0, float(b.abs().max())),
            err_msg=name)


def test_mapper_draws_views_per_block():
    """views_per_iteration = 3: each block draws 3 keyframe indices, with
    replacement."""
    _, pcfg = _cfgs(views_per_iteration=3)
    pm = mapper.Mapper(pcfg, device="cpu")
    probs = mapper.sample_geometric_probs(2, 0.4, 8)
    idx = pm._draw_keyframes(probs, 5)
    assert tuple(idx.shape) == (5, 3)
    assert set(idx.reshape(-1).tolist()) <= {0, 1}


@pytest.fixture(scope="module")
def block_loop_multi(frames):
    """The JAX optimize loop with views_per_iteration = 3 over both
    keyframes, with its start pool and per-block [3] keyframe draws."""
    jcfg, pcfg = _cfgs(views_per_iteration=3)
    jsurf, jadam = _densified(jcfg, frames[0][0], jax.random.PRNGKey(5))
    jprogs = jmapper.MapperPrograms(jcfg, MH, MW, CAP)
    jlm = JLocalModel(jcfg)
    for jfr, _ in frames:
        jlm.insert_keyframe(jfr)
    probs = mapper.sample_geometric_probs(2, 0.4, 8)
    log_probs = np.full((8,), -np.inf, np.float32)
    log_probs[:2] = np.log(probs[:2])
    jkf = jmapper.KeyframeBatch(**jlm.kf_stack,
                                log_probs=jnp.asarray(log_probs))
    n_blocks = mapper.MapperPrograms(pcfg, MH, MW, CAP).n_blocks()
    key = jax.random.PRNGKey(0)
    idx = np.stack([np.asarray(jax.random.categorical(
        k, jnp.asarray(log_probs), shape=(B,)))
        for k in jax.random.split(key, n_blocks)])
    assert len(set(idx.reshape(-1).tolist())) == 2
    return (jsurf, jadam, probs, idx,
            jprogs._optimize(jsurf, jadam, jkf, key))


def test_run_block_loop_views3_same_keyframes(frames, block_loop_multi):
    """The multi-view optimize loop (render_batch + _loss_multi, ranksum
    reduction) on the same [blocks, 3] keyframe draws as the JAX mapper."""
    _, pcfg = _cfgs(views_per_iteration=3)
    jsurf, jadam, probs, idx, (js, ja, jema, jn) = block_loop_multi
    pprogs = mapper.MapperPrograms(pcfg, MH, MW, CAP)
    assert pprogs.views == B
    plm = LocalModel(pcfg, device="cpu")
    for _, pfr in frames:
        plm.insert_keyframe(pfr)
    pkf = mapper.KeyframeBatch(**plm.kf_stack, probs=probs)
    psurf, padam = _port_pool(jsurf, jadam)
    ps, pa, pema, pn = pprogs.optimize(psurf, padam, pkf, torch.tensor(idx))
    assert pn == int(jn) == 8
    assert pa.step == int(ja.step) == 8
    np.testing.assert_allclose(float(pema), float(jema), rtol=EMA_RTOL)
    _assert_pools(ps, js, atol=1e-4, n_iters=pn, lrs=_lrs(pcfg))
