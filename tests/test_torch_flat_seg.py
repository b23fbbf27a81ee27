"""K7's schedule and the K8/K9 row contract of the flat layout on the CPU.

K7 runs K1's slot-parallel body (``csrc/raster_fwd_seg.cuh``) over the
flat slot pool: each tile walks its chunk range and stops at its last slot
of non-zero opacity (the trailing pads point at the view's zero row).  K9
sums the rows of the owned slots that are not pads, and reads no other.

  * the segment model of K1's schedule (``_fwd_segments``,
    tests/test_torch_forward.py) over the flat layout, with K7's index
    maths (tiles of ``kernels._flat_as_tiles``, the count trimmed at the
    last slot of non-zero opacity, tbound moved to the flat chunks)
    against JAX ``_forward_flat`` at the forward tolerances, and against
    K7's plain version in float64 (the same sums regrouped: 1e-9 of
    max|out|, tbound exactly where live).  Two views in one pool, each
    with a tile that owns no chunk, tiles of one chunk and of several,
    tiles ending in pads, an early-exit tile (an opaque stack) and unowned
    budget chunks; P 32 and 64, chunk 32 and 64, with neither and with both
    of the median and the distortion term;
  * K9's plain version against JAX ``_scatter_rows_flat`` over that
    two-view pool, and unchanged (bitwise) when every row it must not read
    (pads, unowned budget chunks) is NaN instead of 0.

The JAX side runs its Pallas kernels in interpret mode.
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwd_layouts import _flat_counts
from test_torch_forward import (CHANNEL_TOL, TILE, W, _case_inputs,
                                _fwd_segments)

from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu_torch.ops.rasterizer import common, kernels

CASES = [(p, c, f) for p in (32, 64) for c in (32, 64) for f in (False, True)]
N_VIEWS = 2


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


@functools.lru_cache(maxsize=None)
def _pool(p_tile: int, chunk: int):
    """Two views (two scenes of tests/test_torch_forward.py, tile 3 cut to
    half a chunk) as one flat pool: numpy (F [2(N+1), 16], ids [2, E] per
    view, starts [2, T+1], tile_of_chunk [2, E/chunk], rays [2T, P, 3],
    pix [2T, P, 2], counts [2T]).  Each tile owns its chunk-padded slots in
    tile order, pads name the view's zero row N, and E leaves two unowned
    budget chunks after the view with more slots."""
    views = [_case_inputs(p_tile, chunk, 7 * p_tile + chunk + v)
             for v in range(N_VIEWS)]
    cut = [c.copy() for _, _, c, _, _ in views]
    for c in cut:
        c[3] = min(c[3], chunk // 2)
    spans = [(c + chunk - 1) // chunk * chunk for c in cut]
    e_view = max(int(s.sum()) for s in spans) + 2 * chunk
    ids, starts, toc = [], [], []
    for (F, lists, _, _, _), counts, span in zip(views, cut, spans):
        n_tiles, pad = lists.shape[0], F.shape[0] - 1
        st = np.concatenate([[0], np.cumsum(span)]).astype(np.int32)
        flat = np.full(e_view, pad, np.int32)
        for t in range(n_tiles):
            flat[st[t]:st[t] + counts[t]] = lists[t, :counts[t]]
        ids.append(flat)
        starts.append(st)
        toc.append(np.minimum(np.searchsorted(
            st[1:], np.arange(0, e_view, chunk), side="right"),
            n_tiles - 1).astype(np.int32))
    cat = [np.concatenate([v[k] for v in views]) for k in (0, 3, 4)]
    return (cat[0], np.stack(ids), np.stack(starts), np.stack(toc), *cat[1:],
            np.concatenate(cut))


def _port_args(pool):
    """The pool as the port's tensors: (F, ids offset into the pool [2E],
    starts, rays, pix)."""
    F, ids, starts, _, rays, pix, _ = pool
    n1 = F.shape[0] // N_VIEWS
    offs = (np.arange(N_VIEWS, dtype=np.int32) * n1)[:, None]
    return tuple(torch.tensor(a) for a in
                 (F, (ids + offs).reshape(-1), starts, rays, pix))


def _flat_segments(F, ids, starts, rays, pix, *, chunk: int, **kw):
    """K7 in plain PyTorch: the segment schedule over each tile's chunk
    range, its slots composited up to the trimmed count, tbound moved to
    the flat chunks (0 for chunks no tile owns).  Also returns the trimmed
    counts."""
    lists, counts, chunk_of, owned = kernels._flat_as_tiles(ids, starts,
                                                            chunk)
    trimmed = _flat_counts(F, lists, counts, chunk)
    out, tb = _fwd_segments(F, lists, counts, rays, pix, chunk=chunk,
                            composited=trimmed, **kw)
    tbound = rays.new_zeros((ids.shape[0] // chunk, rays.shape[1]))
    tbound[chunk_of[owned]] = tb.transpose(1, 2)[owned]
    return out, tbound, trimmed


@pytest.mark.parametrize("p_tile,chunk,flags", CASES)
def test_flat_segment_model_vs_pallas(p_tile, chunk, flags):
    """K7's schedule against JAX ``_forward_flat`` (forward tolerances, the
    median where both cross) and against K7's plain version in float64."""
    pool = _pool(p_tile, chunk)
    F, ids, starts, toc, rays, pix, counts = pool
    n_tiles = starts.shape[1] - 1
    kw = dict(chunk=chunk, width=W, with_median=flags, with_dist=flags)
    jout, jtb = pallas_raster._forward_flat(
        jnp.asarray(F).reshape(N_VIEWS, -1, 16), jnp.asarray(ids),
        jnp.asarray(toc), *(jnp.asarray(a).reshape(N_VIEWS, n_tiles,
                                                   *a.shape[1:])
                            for a in (rays, pix)),
        tile_h=TILE[p_tile][0], tile_w=TILE[p_tile][1], **kw)[:2]
    ref = np.asarray(jout).reshape(N_VIEWS * n_tiles, p_tile, 8)
    ref_tb = np.asarray(jtb)[:, 0]

    args = _port_args(pool)
    out, tb, trimmed = _flat_segments(*args, **kw)
    out, tb = out.numpy(), tb.numpy()
    for c, tol in CHANNEL_TOL:
        np.testing.assert_allclose(out[..., c], ref[..., c], rtol=0,
                                   atol=tol, err_msg=f"channel {c}")
    mo, mr = out[..., 5], ref[..., 5]
    both = (mo > 0) & (mr > 0)
    np.testing.assert_allclose(mo[both], mr[both], rtol=0, atol=1e-4)
    assert both.sum() >= 0.99 * (mr > 0).sum()
    if flags:
        assert (mr > 0).sum() > 0.3 * mr.size
    # JAX routes the unowned budget chunks to each view's last tile
    nc = ids.shape[1] // chunk
    owned = (np.arange(nc)[None, :] < starts[:, -1:] // chunk).reshape(-1)
    np.testing.assert_allclose(tb[owned], ref_tb[owned], rtol=0, atol=2e-5)
    assert not owned.all() and not tb[~owned].any()

    # the layout's cases: chunks per tile 0, 1 and several; pads; the
    # trimmed counts are the real ones; tile 2 of each view stops after
    # its first chunk
    span = (starts[:, 1:] - starts[:, :-1]) // chunk
    assert {0, 1} <= set(span.reshape(-1).tolist()) and span.max() > 1
    np.testing.assert_array_equal(trimmed.numpy(), counts)
    assert (counts % chunk != 0).any()
    for v in range(N_VIEWS):
        first = starts[v, 2] // chunk + v * nc
        assert ref_tb[first + 1:first + span[v, 2]].max() == 0.0
        assert ref[v * n_tiles + 2, :, 7].max() <= common.T_EPS

    a64 = [a.double() if a.is_floating_point() else a for a in args]
    m64, tb64, _ = _flat_segments(*a64, **kw)
    p64, ptb64 = kernels.raster_fwd_flat_plain(*a64, **kw)
    np.testing.assert_allclose(m64.numpy(), p64.numpy(), rtol=0,
                               atol=1e-9 * float(p64.abs().max()))
    np.testing.assert_array_equal(tb64.numpy() > 0, ptb64.numpy() > 0)
    np.testing.assert_allclose(tb64.numpy(), ptb64.numpy(), rtol=0,
                               atol=1e-12)


def _rows_and_skipped(pool, seed):
    """Random rows [2E, 16] of the pool's flat slots and the bool [2E] of
    the slots K9 must not read (pads and unowned budget chunks)."""
    F, ids, starts = _port_args(pool)[:3]
    rows = torch.tensor(np.random.default_rng(seed).normal(
        size=(ids.shape[0], 16)).astype(np.float32))
    skipped = ~kernels._flat_summed_slots(ids, starts, F.shape[0])
    return F, ids, starts, rows, skipped


@pytest.mark.parametrize("chunk", [32, 64])
def test_scatter_rows_flat_two_views_vs_pallas(chunk):
    """K9's plain version over the two-view pool against JAX
    ``_scatter_rows_flat`` on the same rows with the skipped ones 0 (as
    JAX's K8 leaves them): every pool row, the dummy rows 0 in both."""
    pool = _pool(64, chunk)
    F, ids, starts, rows, skipped = _rows_and_skipped(pool, chunk)
    n_rows = F.shape[0]
    zeroed = torch.where(skipped[:, None], 0.0, rows)
    ref = np.asarray(pallas_raster._scatter_rows_flat(
        jnp.asarray(zeroed.reshape(-1, chunk, 16).transpose(1, 2).numpy()),
        jnp.asarray(ids.numpy()), n_rows))
    out = kernels.scatter_rows_flat_plain(rows, ids, starts, n_rows)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    dummy = np.arange(1, N_VIEWS + 1) * (n_rows // N_VIEWS) - 1
    assert not ref[dummy].any() and not out[dummy].any()
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("chunk", [32, 64])
def test_scatter_rows_flat_reads_no_skipped_row(chunk):
    """K9's plain version gives the same dF, bitwise, with every row it must
    not read (pads, unowned budget chunks) set to NaN as set to 0; K8
    writes every other row (csrc/raster_bwd_seg.cuh, Out::FLAT)."""
    F, ids, starts, rows, skipped = _rows_and_skipped(_pool(32, chunk),
                                                      chunk + 1)
    e_view = ids.shape[0] // N_VIEWS
    owned = (torch.arange(e_view)[None, :] < starts[:, -1:]).reshape(-1)
    assert bool((skipped & owned).any()) and not bool(owned.all())
    dF = [kernels.scatter_rows_flat_plain(
        torch.where(skipped[:, None], fill, rows), ids, starts, F.shape[0])
        for fill in (float("nan"), 0.0)]
    assert bool(torch.isfinite(dF[0]).all())
    assert torch.equal(dF[0], dF[1])
