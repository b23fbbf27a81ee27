"""The port's gradient reductions and the bucketed layout against the JAX
package on the CPU (the counterpart of tests/test_reduction_paths.py and
tests/test_pallas_raster.py::test_plan_scatter_gradient_parity).

  * plan construction (occurrence tables, truncated ranksum, tile buckets):
    integer outputs exactly equal to the JAX package's;
  * gradients of scatter="fused" (K5), "plan" (gather-sum + K6), the
    truncated ranksum (K3 + K6) and layout="bucketed" (with "fused" and
    "ranksum"): against JAX ``rasterize_pallas`` with the same settings
    (Pallas in interpret mode) at the repo's gradient tolerances,
    2e-3 * max|g| for parameters and 3e-3 * max|g| for the pose, and
    against the port's own "rmw" path at 1e-5 * max(1, max|g|), the
    tolerance tests/test_reduction_paths.py holds every JAX variant to
    (the same sums in another order);
  * K5's and K6's plain versions against K2 + K4 and ``index_add_``.

On CPU tensors every kernel wrapper runs its plain version.  Wherever an
overflow path is meant to be exercised, the test asserts n_ov > 0.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_binning import _packed
from test_torch_raster import GEO, _loss, _posed, _scene

from splatloam_tpu.ops.rasterizer import RenderParams as JRenderParams
from splatloam_tpu.ops.rasterizer import binning as jbin
from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu_torch.ops.rasterizer import (binning, common, cuda_raster,
                                                kernels)
from splatloam_tpu_torch.ops.rasterizer.api import RenderParams, rasterize

H, W = GEO["height"], GEO["width"]
# a truncation step of 128 entries (group 128, one group per step), so the
# small test scenes overflow a truncated plan; both packages use it
GPS_SMALL = 1


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_raster, "_INTERPRET", True)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.cuda_raster, "
            "splatloam_tpu_torch.ops.rasterizer.kernels, "
            "splatloam_tpu_torch.ops.rasterizer.binning, "
            "splatloam_tpu_torch.ops.rasterizer.api; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _lists(rng, n=400, tile_h=4, tile_w=16, cap=256):
    jp, tp = _packed(rng, n)
    jl, _, _ = jbin.build_tile_lists_sorted(jp, H, W, tile_h, tile_w, cap)
    tl, _, _ = binning.build_tile_lists_sorted(tp, H, W, tile_h, tile_w, cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    return jl, tl


def _assert_equal(port, ref, names):
    assert len(port) == len(ref) == len(names)
    for name, a, b in zip(names, port, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _uncapped_overflow(lists, n, m):
    cnt = torch.bincount(lists.reshape(-1).long(), minlength=n + 1)[:n]
    return int(torch.clamp(cnt - m, min=0).sum())


@pytest.mark.parametrize("m,ov_cap", [(4, 0), (4, 64), (2, 512)])
def test_scatter_plan_equal(rng, m, ov_cap):
    """(occ, ov_slots, ov_ids, n_ov) equal; ov_cap 64 drops entries past
    the cap, as the JAX function's mode="drop" does."""
    n = 400
    jl, tl = _lists(rng, n)
    jplan = jbin.build_scatter_plan(jl, n, m=m, ov_cap=ov_cap)
    tplan = binning.build_scatter_plan(tl, n, m=m, ov_cap=ov_cap)
    _assert_equal(tplan, jplan, ["occ", "ov_slots", "ov_ids", "n_ov"])
    uncapped = _uncapped_overflow(tl, n, m)
    assert int(tplan[3]) == min(uncapped, tplan[1].numel()) > 0
    if ov_cap == 64:
        assert uncapped > ov_cap


def _trunc_for(n_real, tk, step, back_steps=0):
    """trunc_frac whose kept prefix E is the last step multiple below the
    real entry count (minus ``back_steps`` steps): 0 < n_real - E."""
    e_cap = (n_real - 1) // step * step - back_steps * step
    assert step <= e_cap < tk
    return (e_cap + step / 2) / tk


@pytest.mark.parametrize("case", ["overflow", "clipped", "short"])
def test_truncated_ranksum_plan_equal(rng, case):
    """All seven fields equal: with real overflow within ov_cap, with more
    overflow than ov_cap, and with fewer than ov_cap entries after E (the
    overflow lists are then shorter than ov_cap)."""
    n = 400
    jl, tl = _lists(rng, n)
    group, gps = 128, GPS_SMALL
    step = group * gps
    tk = tl.numel()
    n_real = int((tl != n).sum())
    ov_cap = {"overflow": 0, "clipped": 16, "short": 4 * tk}[case]
    trunc = (_trunc_for(n_real, tk, step, back_steps=1) if case == "clipped"
             else _trunc_for(n_real, tk, step))
    kw = dict(group=group, gps=gps, trunc_frac=trunc, ov_cap=ov_cap)
    jplan = jbin.build_ranksum_plan(jl, n, **kw)
    tplan = binning.build_ranksum_plan(tl, n, **kw)
    _assert_equal(tplan, jplan, ["pos", "ranks", "w_first", "rank_of_id",
                                 "ov_slots", "ov_ids", "n_ov"])
    n_ov = int(tplan[6])
    assert n_ov > 0
    if case == "clipped":
        assert n_ov == ov_cap < n_real - tplan[0].numel()
    if case == "short":
        assert tplan[4].numel() == tk - tplan[0].numel() < ov_cap


@pytest.mark.parametrize("q_big,k_small", [(32, 64), (1, 256), (63, 128)])
def test_bucketed_lists_equal(rng, q_big, k_small):
    jp, tp = _packed(rng, 400)
    ref = jbin.build_bucketed_lists(jp, H, W, 4, 16, 256, k_small, q_big)
    out = binning.build_bucketed_lists(tp, H, W, 4, 16, 256, k_small, q_big)
    _assert_equal(out, ref, ["lists_b", "counts_b", "idx_b", "lists_s",
                             "counts_s", "idx_s"])
    assert out[3].shape == (64 - q_big, k_small)


# settings of each reduction or layout under test; "ranksum-trunc" picks
# RS_TRUNC from the scene's real slot count (see _with_truncation)
MODES = {
    "fused": dict(scatter="fused"),
    "plan": dict(scatter="plan"),
    "ranksum-trunc": dict(scatter="ranksum"),
    "bucketed-fused": dict(scatter="fused", layout="bucketed"),
    "bucketed-ranksum": dict(scatter="ranksum", layout="bucketed"),
}


def _with_truncation(monkeypatch, scene, params):
    """Set both packages' ranksum step to 128 entries and RS_TRUNC so the
    truncated plan spills real entries into the overflow list."""
    monkeypatch.setattr(cuda_raster, "RS_GPS", GPS_SMALL)
    monkeypatch.setattr(pallas_raster, "_RS_GPS", GPS_SMALL)
    tiles = cuda_raster.prepare_tiles(*map(torch.tensor, scene), params)
    n_real = int(tiles.counts.sum())
    trunc = _trunc_for(n_real, tiles.lists.numel(), 128 * GPS_SMALL)
    monkeypatch.setattr(cuda_raster, "RS_TRUNC", trunc)
    monkeypatch.setattr(pallas_raster, "_RS_TRUNC", trunc)


def _port_grads(scene, params):
    leaves = [torch.tensor(a, requires_grad=True) for a in scene[:5]]
    out = rasterize(*leaves, torch.tensor(scene[5]), params)
    return [g.numpy() for g in torch.autograd.grad(_loss(out), leaves)]


def _assert_overflow_used(scene, params, mode):
    """The scene exercises the path each mode is about."""
    tiles = cuda_raster.prepare_tiles(*map(torch.tensor, scene), params)
    if mode in ("plan", "ranksum-trunc"):
        assert int(tiles.plan.n_ov) > 0, "scene no longer overflows"
    if mode.startswith("bucketed"):
        assert tiles.lists_s.shape[1] == GEO["chunk"]     # tbound [Qs, P, 1]
        assert isinstance(tiles.plan, cuda_raster.RanksumPlan) == \
            (mode == "bucketed-ranksum")
        # no small-bucket tile was cut, so "rmw" is an exact oracle
        assert int(tiles.counts_s.max()) < GEO["chunk"]


@pytest.mark.parametrize("mode", list(MODES))
def test_gradient_parity_vs_pallas_and_rmw(rng, monkeypatch, mode):
    scene = _posed(_scene(rng, n=120))
    params = RenderParams(backend="cuda", **MODES[mode], **GEO)
    if mode == "ranksum-trunc":
        _with_truncation(monkeypatch, scene, params)
    _assert_overflow_used(scene, params, mode)
    g_port = _port_grads(scene, params)

    jparams = JRenderParams(backend="pallas", **MODES[mode], **GEO)
    jK = jnp.asarray(scene[5])
    g_ref = jax.grad(
        lambda *a: _loss(pallas_raster.rasterize_pallas(*a, jK, jparams)),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, scene[:5]))
    g_rmw = _port_grads(scene, params._replace(scatter="rmw",
                                               layout="tiled"))
    names = ["xyz", "scales", "quat", "opacity", "T_cw"]
    for name, gp, gr, gm, rel in zip(names, g_port, g_ref, g_rmw,
                                     [2e-3] * 4 + [3e-3]):
        gr = np.asarray(gr)
        np.testing.assert_allclose(gp, gr,
                                   atol=rel * (np.abs(gr).max() + 1e-6),
                                   err_msg=f"{mode} vs pallas: {name}")
        np.testing.assert_allclose(gp, gm,
                                   atol=1e-5 * max(1.0, np.abs(gm).max()),
                                   err_msg=f"{mode} vs rmw: {name}")


def _rows(rng, scene, params):
    """Tiles of a numpy scene, K2's plain rows for random output
    cotangents, and K4's plain reduction of them."""
    scene = [torch.tensor(a) for a in scene]
    tiles = cuda_raster.prepare_tiles(*scene, params)
    F = binning.pack_features(common.pack_surfels(*scene))
    kw = dict(chunk=params.chunk, width=W)
    out, tb = kernels.raster_fwd_plain(F, tiles.lists, tiles.counts,
                                       tiles.rays_t, tiles.pix_t,
                                       with_median=True, with_dist=True,
                                       **kw)
    g = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32))
    bargs = (F, tiles.lists, tiles.counts, tiles.rays_t, tiles.pix_t, tb,
             out, g)
    dFg = kernels.raster_bwd_plain(*bargs, with_dist=True, **kw)
    dF4 = kernels.scatter_rows_plain(dFg, tiles.lists, tiles.counts,
                                     F.shape[0])
    return tiles, bargs, dFg, dF4


def test_fused_plain_equals_bwd_then_scatter(rng):
    """K5's plain version (and its wrapper on CPU tensors) is K2 + K4."""
    params = RenderParams(backend="cuda", scatter="fused", **GEO)
    _, bargs, _, dF4 = _rows(rng, _scene(rng), params)
    kw = dict(chunk=params.chunk, width=W, with_dist=True)
    n_rows = bargs[0].shape[0]
    dF5 = kernels.raster_bwd_fused_plain(*bargs, n_rows, **kw)
    np.testing.assert_array_equal(dF5.numpy(), dF4.numpy())
    np.testing.assert_array_equal(
        kernels.raster_bwd_fused(*bargs, n_rows, **kw).numpy(), dF4.numpy())
    assert float(dF4.abs().max()) > 0


def test_overflow_plain_matches_index_add(rng):
    rows = torch.tensor(rng.normal(size=(900, 16)).astype(np.float32))
    slots = torch.tensor(rng.permutation(900)[:700].astype(np.int32))
    ids = torch.tensor(rng.integers(0, 50, 700).astype(np.int32))
    n_ov = torch.tensor(613, dtype=torch.int32)
    ref = torch.zeros((51, 16)).index_add_(0, ids[:613].long(),
                                           rows[slots[:613].long()])
    for fn in (kernels.scatter_overflow_plain, kernels.scatter_overflow):
        np.testing.assert_array_equal(fn(rows, slots, ids, n_ov, 51).numpy(),
                                      ref.numpy())


@pytest.mark.parametrize("mode", ["plan", "ranksum-trunc"])
def test_overflow_reductions_equal_scatter(rng, monkeypatch, mode):
    """Plan gather-sum + K6, and truncated K3 + K6, against K4 on the same
    rows (rows [:-1]: the dummy row N differs by design)."""
    params = RenderParams(backend="cuda", **MODES[mode], **GEO)
    scene = _scene(rng)
    if mode == "ranksum-trunc":
        _with_truncation(monkeypatch, scene, params)
    tiles, _, dFg, dF4 = _rows(rng, scene, params)
    assert int(tiles.plan.n_ov) > 0
    n_rows = dF4.shape[0]
    rows = dFg.reshape(-1, 16)
    if mode == "plan":
        dF = cuda_raster._scatter_with_plan(rows, tiles.plan, n_rows)
    else:
        dF = cuda_raster._reduce_rows_with_ranksum(rows, tiles.plan, n_rows)
    np.testing.assert_allclose(dF[:-1].numpy(), dF4[:-1].numpy(),
                               atol=1e-5 * max(1.0, float(dF4.abs().max())))
