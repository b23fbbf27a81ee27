"""The port's flat slot layout (``layout="flat"``: build_flat_lists, K7
forward, K8 backward, K9 scatter-add) against the JAX package on the CPU.

  * build_flat_lists: the four integer outputs equal JAX's exactly, with a
    drop-free budget, an undersized one (greedy fill in tile order, the
    tail tiles lose their deepest entries) and an empty scene;
  * the plain versions of K7 and K8 (+ K9) against JAX ``_forward_flat`` /
    ``_backward_flat`` on the same inputs, and K9's against
    ``_scatter_rows_flat``;
  * the flat render against JAX's flat render and the port's tiled one,
    values and gradients, one view and B = 2 views.

The JAX side runs its Pallas kernels in interpret mode.  Tolerances are
the repo's (tests/test_pallas_raster.py): alpha and final T 2e-5, depth
and normal sums 2e-4, dist 3e-4, median 1e-4 where both cross; gradients
2e-3 * max|g|, pose gradients 3e-3 * max|g|; sums of the same rows in
another order 1e-5 * max(1, max|row|).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_raster import GEO, _loss, _posed, _scene

from splatloam_tpu.ops.rasterizer import RenderParams as JRenderParams
from splatloam_tpu.ops.rasterizer import binning as jbin
from splatloam_tpu.ops.rasterizer import common as jcommon
from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu_torch.ops.rasterizer import binning, kernels
from splatloam_tpu_torch.ops.rasterizer.api import (RenderParams, rasterize,
                                                    render, render_batch)
from splatloam_tpu_torch.ops.rasterizer.cuda_raster import (
    FlatTiles, prepare_tiles, rasterize_cuda_batched)

H, W = GEO["height"], GEO["width"]
N_TILES = (H // GEO["tile_h"]) * (W // GEO["tile_w"])
CHUNK = GEO["chunk"]
# budgets: every tile's chunks fit (T*K), and six chunks for the scene
BUDGETS = {"drop-free": N_TILES * GEO["tile_list_capacity"],
           "undersized": 6 * CHUNK}
FLAT = dict(GEO, layout="flat", flat_capacity=BUDGETS["drop-free"])
NAMES = ["xyz", "scales", "quat", "opacity", "T_cw"]
RELS = [2e-3] * 4 + [3e-3]
# kernel output channels: (columns, tolerance); median (5) separately
OUT_TOL = [(slice(0, 1), 2e-4), (slice(1, 2), 2e-5), (slice(2, 5), 2e-4),
           (slice(6, 7), 3e-4), (slice(7, 8), 2e-5)]


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


def _packed(scene):
    """The scene packed by JAX, and the same numbers as the port's
    PackedSurfels."""
    from splatloam_tpu_torch.ops.rasterizer import common
    jp = jcommon.pack_surfels(*map(jnp.asarray, scene))
    tp = common.PackedSurfels(*(torch.tensor(np.asarray(a)) for a in jp))
    return jp, tp


def _flat_lists(jp, tp, budget):
    args = (H, W, GEO["tile_h"], GEO["tile_w"], GEO["tile_list_capacity"],
            CHUNK, budget)
    return (jbin.build_flat_lists(jp, *args),
            binning.build_flat_lists(tp, *args))


@pytest.mark.parametrize("case", ["drop-free", "undersized", "empty"])
def test_build_flat_lists_equal(rng, case):
    """(flat_ids, tile_of_chunk, starts, counts) equal JAX's; the
    undersized budget drops the tail tiles' deepest entries, and the empty
    scene (every surfel culled) bins nothing."""
    jp, tp = _packed(_scene(rng, n=600))
    if case == "empty":
        jp = jp._replace(radius_px=jnp.zeros_like(jp.radius_px))
        tp = dataclasses.replace(tp,
                                 radius_px=torch.zeros_like(tp.radius_px))
    budget = BUDGETS.get(case, BUDGETS["drop-free"])
    jout, tout = _flat_lists(jp, tp, budget)
    for name, a, b in zip(["flat_ids", "tile_of_chunk", "starts", "counts"],
                          tout, jout):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    flat_ids, _, starts, counts2 = tout
    n = tp.depth.shape[0]
    lists, counts, _ = binning.build_tile_lists_sorted(
        tp, H, W, GEO["tile_h"], GEO["tile_w"], GEO["tile_list_capacity"])
    if case == "empty":
        assert int(counts2.sum()) == 0 and bool((flat_ids == n).all())
        return
    # each tile keeps its nearest entries, in depth order
    for t in range(N_TILES):
        c = int(counts2[t])
        np.testing.assert_array_equal(
            flat_ids[int(starts[t]):int(starts[t]) + c].numpy(),
            lists[t, :c].numpy())
    dropped = int((counts - counts2).sum())
    assert (dropped > 0) == (case == "undersized")
    assert int(starts[-1]) <= budget


def _flat_inputs(rng, budget, n=400):
    """F, flat lists, rays and pix of one posed scene, as JAX arrays and as
    the port's tensors (the same numbers)."""
    scene = _posed(_scene(rng, n=n))
    jp, tp = _packed(scene)
    (jids, jtoc, jst, _), _ = _flat_lists(jp, tp, budget)
    jF = jbin.pack_features(jp)
    jrays, jpix = jbin.tile_rays(jnp.asarray(scene[5]), H, W, GEO["tile_h"],
                                 GEO["tile_w"])
    jx = dict(F=jF, ids=jids, toc=jtoc, rays=jrays, pix=jpix)
    tx = {k: torch.tensor(np.asarray(v)) for k, v in jx.items()}
    tx["starts"] = torch.tensor(np.asarray(jst))[None]
    return jx, tx


@pytest.mark.parametrize("budget", ["drop-free", "undersized"])
def test_flat_kernels_plain_vs_jax(rng, budget):
    """K7's plain version against _forward_flat, K8's + K9's against
    _backward_flat, on the same inputs.  The drop-free budget leaves
    trailing budget chunks, which the JAX grid routes to the last tile and
    the port's K7/K8 skip: the outputs still agree, and those chunks keep
    tbound 0 in the port."""
    jx, tx = _flat_inputs(rng, BUDGETS[budget])
    jkw = dict(tile_h=GEO["tile_h"], tile_w=GEO["tile_w"], chunk=CHUNK,
               width=W, with_median=True, with_dist=True)
    jout, jtb, jFg, jtoc = pallas_raster._forward_flat(
        jx["F"][None], jx["ids"][None], jx["toc"][None], jx["rays"][None],
        jx["pix"][None], **jkw)
    targs = (tx["F"], tx["ids"], tx["starts"], tx["rays"], tx["pix"])
    out, tb = kernels.raster_fwd_flat_plain(*targs, chunk=CHUNK, width=W,
                                            with_median=True, with_dist=True)
    ref = np.asarray(jout)[0]
    for cols, tol in OUT_TOL:
        np.testing.assert_allclose(out[..., cols].numpy(), ref[..., cols],
                                   atol=tol, err_msg=str(cols))
    mo, mr = out[..., 5].numpy(), ref[..., 5]
    both = (mo > 0) & (mr > 0)
    np.testing.assert_allclose(mo[both], mr[both], atol=1e-4)
    assert both.sum() > 0.99 * max((mr > 0).sum(), 1)
    owned = int(tx["starts"][0, -1]) // CHUNK
    np.testing.assert_allclose(tb[:owned].numpy(),
                               np.asarray(jtb)[:owned, 0], atol=2e-5)
    assert bool((tb[owned:] == 0).all())
    if budget == "drop-free":
        assert owned < tb.shape[0]          # trailing budget chunks exist

    g = rng.normal(size=ref.shape).astype(np.float32)
    jdF = pallas_raster._backward_flat(
        jFg, jtoc, jx["rays"][None], jx["pix"][None], jtb, jout,
        jnp.asarray(g)[None], jx["F"].shape[0], jx["ids"][None], **jkw)
    rows = kernels.raster_bwd_flat_plain(
        *targs, tb, out, torch.tensor(g), chunk=CHUNK, width=W,
        with_dist=True)
    assert bool((rows.reshape(-1, CHUNK, 16)[owned:] == 0).all())
    dF = kernels.scatter_rows_flat_plain(rows, tx["ids"], tx["starts"],
                                         tx["F"].shape[0])
    jdF = np.asarray(jdF)[0]
    np.testing.assert_allclose(dF.numpy(), jdF,
                               atol=2e-3 * np.abs(jdF).max())
    assert np.abs(jdF).max() > 0


def test_scatter_rows_flat_plain_vs_jax(rng):
    """K9's plain version against _scatter_rows_flat on random rows.  K9
    reads only the rows of owned slots that are not pads; JAX sums every
    slot, so it gets the same random rows with those others set to 0 (as
    its K8 makes them), and the dummy row N is 0 in both."""
    _, tx = _flat_inputs(rng, BUDGETS["drop-free"])
    ids, starts = tx["ids"], tx["starts"]
    n_rows = tx["F"].shape[0]
    rows = torch.tensor(rng.normal(size=(ids.shape[0], 16))
                        .astype(np.float32))
    keep = kernels._flat_summed_slots(ids, starts, n_rows)
    assert 0 < int(keep.sum()) < int(starts[0, -1]) < ids.shape[0]
    zeroed = torch.where(keep[:, None], rows, 0.0)
    dFg = zeroed.reshape(-1, CHUNK, 16).transpose(1, 2)
    ref = np.asarray(pallas_raster._scatter_rows_flat(
        jnp.asarray(dFg.numpy()), jnp.asarray(ids.numpy()), n_rows))
    out = kernels.scatter_rows_flat_plain(rows, ids, starts, n_rows)
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert not ref[-1].any() and not out[-1].any()


@pytest.mark.parametrize("posed", [False, True])
def test_flat_forward_vs_jax_and_tiled(rng, posed):
    scene = _scene(rng, n=600)
    if posed:
        scene = _posed(scene)
    ref = pallas_raster.rasterize_pallas(
        *map(jnp.asarray, scene), JRenderParams(backend="pallas", **FLAT))
    tscene = [torch.tensor(a) for a in scene]
    flat = rasterize(*tscene, RenderParams(backend="cuda", **FLAT))
    tiled = rasterize(*tscene, RenderParams(backend="cuda", **GEO))
    for key, tol in [("alpha", 2e-5), ("depth_sum", 2e-4),
                     ("normal_sum", 2e-4), ("dist", 3e-4),
                     ("final_T", 2e-5)]:
        np.testing.assert_allclose(flat[key].numpy(), np.asarray(ref[key]),
                                   atol=tol, err_msg=f"flat vs JAX {key}")
        np.testing.assert_allclose(flat[key].numpy(), tiled[key].numpy(),
                                   atol=tol, err_msg=f"flat vs tiled {key}")


def test_flat_empty_tiles_render_empty_state(rng):
    """Zero opacity: every tile is unvisited or self-neutralised, and
    comes out as the empty state (alpha 0, final T 1, finite)."""
    scene = [torch.tensor(a) for a in _scene(rng, n=64)]
    scene[3] = torch.zeros_like(scene[3])
    out = rasterize(*scene, RenderParams(backend="cuda", **FLAT))
    assert bool(torch.isfinite(out["depth_sum"]).all())
    assert bool((out["alpha"] == 0).all())
    assert bool((out["final_T"] == 1).all())


def _jax_channels_and_grads(fn, scene):
    """JAX channels of fn(*scene[:5]) and the gradients of _loss of them,
    from one pass."""
    (_, chans), grads = jax.value_and_grad(
        lambda *a: (lambda c: (_loss(c), c))(fn(*a)), argnums=(0, 1, 2, 3, 4),
        has_aux=True)(*map(jnp.asarray, scene[:5]))
    return chans, [np.asarray(g) for g in grads]


def _grads_port(fn, scene):
    leaves = [torch.tensor(a, requires_grad=True) for a in scene[:5]]
    return torch.autograd.grad(_loss(fn(*leaves)), leaves)


def _assert_grads(port, ref, label):
    for name, gp, gr, rel in zip(NAMES, port, ref, RELS):
        np.testing.assert_allclose(gp.numpy(), gr,
                                   atol=rel * (np.abs(gr).max() + 1e-6),
                                   err_msg=f"{label} {name}")


def test_flat_gradients_vs_jax(rng):
    """Parameter and pose gradients: K7 + K8 + K9 plain versions against
    the JAX flat path, through pack_surfels."""
    scene = _posed(_scene(rng, n=150))
    jp = JRenderParams(backend="pallas", **FLAT)
    jK = jnp.asarray(scene[5])
    _, g_ref = _jax_channels_and_grads(
        lambda *a: pallas_raster.rasterize_pallas(*a, jK, jp), scene)
    tp = RenderParams(backend="cuda", **FLAT)
    tK = torch.tensor(scene[5])
    _assert_grads(_grads_port(lambda *a: rasterize(*a, tK, tp), scene),
                  g_ref, "flat")


def _views(scene, b):
    """B poses around the scene's (rotations and small shifts)."""
    angs = [0.0, 0.25, -0.4][:b]
    T_b = np.stack([np.array(
        [[np.cos(a), -np.sin(a), 0, 0.1 * i],
         [np.sin(a), np.cos(a), 0, -0.05 * i],
         [0, 0, 1, 0.02 * i], [0, 0, 0, 1]], np.float32)
        for i, a in enumerate(angs)])
    return [*scene[:4], T_b, np.stack([scene[5]] * b)]


def test_flat_render_batch_two_views(rng):
    """B = 2 through the flat layout: the batched channels and gradients
    (the pose's per view) against JAX rasterize_pallas_batched, and
    render_batch against two single-view renders."""
    scene = _views(_scene(rng, n=150), 2)
    jp = JRenderParams(backend="pallas", **FLAT)
    tp = RenderParams(backend="cuda", **FLAT)
    jK, tK = jnp.asarray(scene[5]), torch.tensor(scene[5])
    ref, g_ref = _jax_channels_and_grads(
        lambda *a: pallas_raster.rasterize_pallas_batched(*a, jK, jp), scene)
    tscene = [torch.tensor(a) for a in scene]
    tiles = prepare_tiles(*tscene[:4], tscene[4][1], tK[1], tp)
    assert isinstance(tiles, FlatTiles)
    out = rasterize_cuda_batched(*tscene, tp)
    for key, tol in [("alpha", 2e-5), ("depth_sum", 2e-4),
                     ("normal_sum", 2e-4), ("dist", 3e-4),
                     ("final_T", 2e-5)]:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=tol, err_msg=key)
    _assert_grads(_grads_port(
        lambda *a: rasterize_cuda_batched(*a, tK, tp), scene), g_ref,
        "flat B=2")

    pkg = render_batch(*tscene, tp)
    for v in range(2):
        one = render(*tscene[:4], tscene[4][v], tK[v], tp)
        for key in ("rend_alpha", "surf_depth", "rend_normal", "rend_dist"):
            np.testing.assert_allclose(pkg[key][v].numpy(), one[key].numpy(),
                                       atol=1e-5, err_msg=f"view {v} {key}")
