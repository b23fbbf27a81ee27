"""The backward body's two other write modes against the JAX package on
the CPU: K5's (each composited slot's row added into the surfel pool by
id) and K8's (rows of the flat slot pool, the tile's trailing pads
skipped).  K2, K5 and K8 share one slot-parallel body on the card
(``csrc/raster_bwd_seg.cuh``); ``_bwd_segments`` (the CPU model of its
segment schedule, tests/test_torch_backward.py) stands in for it here.

  * fused: a 2-view pool (view 1's ids offset by N+1, as
    ``render_batch`` lays them out) of tiled lists with a tile of count 0
    and a tile of count K; the model's rows reduced by id with
    ``scatter_rows_plain`` against JAX ``_bwd_call_fused``;
  * flat: a budget that cuts the tile order, so tiles own several chunks,
    one chunk or none, and the owning tiles end in pads; the model over
    ``kernels._flat_as_tiles`` with K8's index maths (the chunk-major
    tbound and the count trimmed at the last slot of non-zero opacity),
    mapped to flat rows and summed with ``scatter_rows_flat_plain``,
    against JAX ``_backward_flat``; the trimmed counts equal the binning's
    real counts, and the rows equal K8's plain version (which composites
    the pads) in float64.

Scenes of 400 surfels at 16x128, P 32 and 64, chunk 32 and 64, with and
without the distortion term.  The JAX side runs its Pallas kernels in
interpret mode.  Tolerance 2e-3 * max|dF|, the repo's gradient
tolerance; the same sums regrouped in float64 1e-9 * max|row|.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backward import _bwd_segments, _surfels

from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu_torch.geometry import spherical
from splatloam_tpu_torch.ops.rasterizer import binning, common, kernels
from splatloam_tpu_torch.ops.rasterizer.api import RenderParams
from splatloam_tpu_torch.ops.rasterizer.cuda_raster import prepare_tiles

H, W = 16, 128
N_SCENE = 400
# (tile_h, chunk, with_dist): P 32 and 64, chunk 32 and 64, each flag
CASES = [(2, 32, False), (2, 64, True), (4, 32, True), (4, 64, False)]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_raster, "_INTERPRET", True)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.kernels, "
            "splatloam_tpu_torch.ops.rasterizer.cuda_raster; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _scene(rng):
    theta = rng.uniform(-np.pi, np.pi, N_SCENE)
    xyz = np.stack([7 * np.cos(theta), 7 * np.sin(theta),
                    rng.uniform(-1.0, 1.5, N_SCENE)], -1)
    scene = _surfels(xyz, rng.uniform(0.2, 0.6, (N_SCENE, 2)),
                     rng.uniform(0.3, 0.95, N_SCENE))
    return scene, spherical.spherical_intrinsics(scene[0], H, W)[0]


def _pose(v):
    ang, T = 0.4 * v, torch.eye(4)
    T[:2, :2] = torch.tensor([[np.cos(ang), -np.sin(ang)],
                              [np.sin(ang), np.cos(ang)]])
    T[:3, 3] = torch.tensor([0.3 * v, -0.2 * v, 0.05 * v])
    return T


def _params(tile_h, chunk, **kw):
    return RenderParams(height=H, width=W, backend="cuda", chunk=chunk,
                        tile_h=tile_h, tile_w=16,
                        tile_list_capacity=3 * chunk, **kw)


def _assert_sums(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())
    assert np.abs(ref).max() > 0


def _jax_forward(F, lists, counts, rays, pix, chunk, with_dist):
    """JAX ``_fwd_call`` over one pool F [R, 16] and its lists [T, K]:
    (Fg, out, tbound), the forward that feeds both sides."""
    Fg = pallas_raster._gather_features(jnp.asarray(F.numpy())[None],
                                        jnp.asarray(lists.numpy())[None])
    out, tbound = pallas_raster._fwd_call(
        Fg, jnp.asarray(counts.numpy()), jnp.asarray(rays.numpy()),
        jnp.asarray(pix.numpy()), chunk=chunk, width=W, with_median=False,
        with_dist=with_dist)
    return Fg, out, tbound


@pytest.mark.parametrize("tile_h,chunk,with_dist", CASES)
def test_fused_write_mode_vs_pallas(rng, tile_h, chunk, with_dist):
    """K5's write mode over a 2-view pool: the segment model's rows of the
    composited slots added into dF[lists[t, j]] equal JAX
    ``_bwd_call_fused``, and so does K5's plain version."""
    (xyz, sc, quat, opac), K = _scene(rng)
    params = _params(tile_h, chunk)
    k_cap = params.tile_list_capacity
    feats, lists, counts, rays, pix = [], [], [], [], []
    n1 = N_SCENE + 1
    for v in range(2):
        T_cw = _pose(v)
        tiles = prepare_tiles(xyz, sc, quat, opac, T_cw, K, params)
        feats.append(binning.pack_features(common.pack_surfels(
            xyz, sc, quat, opac, T_cw, K)))
        lv, cv = tiles.lists.clone(), tiles.counts.clone()
        if v == 0:
            # tile 0 empty; tile 1 filled to K with surfels it lacks
            cv[0] = 0
            lv[0] = N_SCENE
            rest = lv[1, :cv[1]]
            others = torch.tensor(rng.permutation(np.setdiff1d(
                np.arange(N_SCENE), rest.numpy())).astype(np.int32))
            lv[1] = torch.cat([rest, others])[:k_cap]
            cv[1] = k_cap
        lists.append(lv + v * n1)
        counts.append(cv)
        rays.append(tiles.rays_t)
        pix.append(tiles.pix_t)
    F, lists, counts, rays, pix = (torch.cat(x) for x in
                                   (feats, lists, counts, rays, pix))
    n_rows = F.shape[0]
    g = rng.normal(size=(lists.shape[0], rays.shape[1], 8)).astype(
        np.float32)
    Fg, out, tbound = _jax_forward(F, lists, counts, rays, pix, chunk,
                                   with_dist)
    ref = pallas_raster._bwd_call_fused(
        Fg, jnp.asarray(counts.numpy()), jnp.asarray(rays.numpy()),
        jnp.asarray(pix.numpy()), tbound, out, jnp.asarray(g),
        jnp.asarray(lists.numpy()), n_rows, chunk=chunk, width=W,
        with_median=False, with_dist=with_dist)
    bargs = (F, lists, counts, rays, pix, torch.tensor(np.asarray(tbound)),
             torch.tensor(np.asarray(out)), torch.tensor(g))
    kw = dict(chunk=chunk, width=W, with_dist=with_dist)
    rows = _bwd_segments(*bargs, **kw)
    _assert_sums(kernels.scatter_rows_plain(rows, lists, counts, n_rows),
                 ref)
    _assert_sums(kernels.raster_bwd_fused(*bargs, n_rows, **kw), ref)
    # both views reach the pool, and the empty tile adds nothing
    ref = np.asarray(ref)
    assert np.abs(ref[:N_SCENE]).max() > 0
    assert np.abs(ref[n1:n1 + N_SCENE]).max() > 0
    assert np.abs(np.asarray(rows[0])).max() == 0


def _flat_counts(F, lists, counts, chunk):
    """K8's count of each tile of ``kernels._flat_as_tiles``: the tile's
    chunk-aligned count trimmed to its last slot of non-zero opacity
    within its last chunk (pads point at the zero row)."""
    trimmed = counts.clone()
    for t in range(lists.shape[0]):
        n = int(counts[t])
        if n == 0:
            continue
        opa = F[lists[t, n - chunk:n].long(), 12]
        nz = torch.nonzero(opa != 0)
        trimmed[t] = n - chunk + (int(nz[-1]) + 1 if nz.numel() else 0)
    return trimmed


def _flat_model(F, ids, starts, rays, pix, tbound, outs, g, *, chunk,
                width, with_dist):
    """K8 in plain PyTorch: the segment schedule over each tile's chunk
    range, chunk i's start T read at flat chunk slot0/chunk + i, the walk
    ended at the trimmed count; rows [B*E, 16] by flat slot (0 where no
    slot is composited).  Also returns the trimmed counts."""
    lists, counts, chunk_of, owned = kernels._flat_as_tiles(ids, starts,
                                                            chunk)
    trimmed = _flat_counts(F, lists, counts, chunk)
    n_tiles, m = owned.shape
    tb = tbound.new_zeros((n_tiles, m, tbound.shape[1]))
    tb[owned] = tbound[chunk_of[owned]]
    dFg = _bwd_segments(F, lists, trimmed, rays, pix, tb.transpose(1, 2),
                        outs, g, chunk=chunk, width=width,
                        with_dist=with_dist)
    rows = F.new_zeros((ids.shape[0] // chunk, chunk, 16))
    rows[chunk_of[owned]] = dFg.reshape(n_tiles, m, chunk, 16)[owned]
    return rows.reshape(-1, 16), trimmed


@pytest.mark.parametrize("tile_h,chunk,with_dist", CASES)
def test_flat_write_mode_vs_pallas(rng, tile_h, chunk, with_dist):
    """K8's write mode and index maths: the model's rows summed by slot id
    equal JAX ``_backward_flat``; its trimmed counts are the binning's
    real counts; its rows equal K8's plain version in float64, the pads'
    rows 0."""
    (xyz, sc, quat, opac), K = _scene(rng)
    T_cw = _pose(1)
    params = _params(tile_h, chunk)
    full = prepare_tiles(xyz, sc, quat, opac, T_cw, K, params)
    padded = int(((full.counts + chunk - 1) // chunk * chunk).sum())
    budget = padded // 2 // chunk * chunk
    ft = prepare_tiles(xyz, sc, quat, opac, T_cw, K,
                       params._replace(layout="flat", flat_capacity=budget))
    span = (ft.starts[1:] - ft.starts[:-1]) // chunk
    assert int((span == 0).sum()) > 0 and int((span > 1).sum()) > 0
    F = binning.pack_features(common.pack_surfels(xyz, sc, quat, opac, T_cw,
                                                  K))
    n1 = F.shape[0]
    jkw = dict(tile_h=tile_h, tile_w=16, chunk=chunk, width=W,
               with_median=False, with_dist=with_dist)
    j = [jnp.asarray(x.numpy())[None] for x in
         (F, ft.flat_ids, ft.tile_of_chunk, ft.rays_t, ft.pix_t)]
    jout, jtb, jFg, jtoc = pallas_raster._forward_flat(*j, **jkw)
    g = rng.normal(size=jout.shape[1:]).astype(np.float32)
    ref = pallas_raster._backward_flat(
        jFg, jtoc, j[3], j[4], jtb, jout, jnp.asarray(g)[None], n1, j[1],
        **jkw)[0]

    owned = int(ft.starts[-1]) // chunk
    tbound = torch.tensor(np.asarray(jtb)[:, 0])
    tbound[owned:] = 0.0
    args = (F, ft.flat_ids, ft.starts[None], ft.rays_t, ft.pix_t, tbound,
            torch.tensor(np.asarray(jout)[0]), torch.tensor(g))
    kw = dict(chunk=chunk, width=W, with_dist=with_dist)
    rows, trimmed = _flat_model(*args, **kw)
    np.testing.assert_array_equal(trimmed.numpy(), ft.counts.numpy())
    assert int((trimmed % chunk != 0).sum()) > 0      # tiles end in pads
    _assert_sums(kernels.scatter_rows_flat_plain(rows, ft.flat_ids,
                                                 ft.starts[None], n1), ref)

    a64 = [a.double() if a.is_floating_point() else a for a in args]
    r64 = _flat_model(*a64, **kw)[0]
    p64 = kernels.raster_bwd_flat_plain(*a64, **kw)
    np.testing.assert_allclose(r64.numpy(), p64.numpy(), rtol=0,
                               atol=1e-9 * float(p64.abs().max()))
    pads = ft.flat_ids == N_SCENE
    assert bool(pads.any()) and float(r64[pads].abs().max()) == 0
