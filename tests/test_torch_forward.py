"""The port's forward kernel K1 (``kernels.raster_fwd``) and a CPU model of
its slot-parallel schedule (``_fwd_segments`` below) against the JAX
package's ``pallas_raster._fwd_call`` on the CPU.

Inputs: a seeded scene packed by the port (features F, tile rays and
pixels at 2x16, 4x16 and 8x32 tiles: P = 32, 64 and a 256-pixel tile
that spans four 64-pixel groups), hand-set tile lists with a tile of
count 0, a tile of count K, and a tile whose first slots are six opaque
surfels stacked beside one pixel's ray and wide enough to cover the
tile, so every pixel's T falls under T_EPS in the first chunk and the
tile stops there.  The JAX side runs its Pallas kernel in interpret mode;
on CPU tensors the port's wrapper runs its plain version.  Tolerances
are the JAX package's forward tolerances (tests/test_pallas_raster.py):
alpha and T 2e-5, depth and normal sums 2e-4, dist 3e-4, the median
1e-4 where both cross T = 0.5 and crossing at >= 99% of the pixels where
the reference does (a pixel at the 0.5 tie may go either way).
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu_torch.geometry import se3, spherical
from splatloam_tpu_torch.ops.rasterizer import binning, common, kernels
from splatloam_tpu_torch.ops.rasterizer.api import RenderParams
from splatloam_tpu_torch.ops.rasterizer.cuda_raster import prepare_tiles

H, W = 8, 128
N_SCENE = 300
N_OPAQUE = 6
TILE = {32: (2, 16), 64: (4, 16), 256: (8, 32)}
# out channels and their tolerances against JAX; 5 is the median
CHANNEL_TOL = [(0, 2e-4), (1, 2e-5), (2, 2e-4), (3, 2e-4), (4, 2e-4),
               (6, 3e-4), (7, 2e-5)]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_raster, "_INTERPRET", True)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.kernels; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _surfels(xyz, scales, opac):
    xyz = torch.tensor(xyz, dtype=torch.float32)
    quat = se3.quat_from_normal(-xyz / torch.linalg.norm(xyz, dim=-1,
                                                         keepdim=True))
    return [xyz, torch.tensor(scales, dtype=torch.float32), quat,
            torch.tensor(opac, dtype=torch.float32)]


@functools.lru_cache(maxsize=None)
def _case_inputs(p_tile: int, chunk: int, seed: int):
    """numpy (F, lists, counts, rays, pix) of one scene: tile 0 of count 0,
    tile 1 of count K, tile 2 of count K led by the opaque stack."""
    rng = np.random.default_rng(seed)
    tile_h, tile_w = TILE[p_tile]
    theta = rng.uniform(-np.pi, np.pi, N_SCENE)
    xyz = np.stack([7 * np.cos(theta), 7 * np.sin(theta),
                    rng.uniform(-1.0, 1.5, N_SCENE)], -1)
    scene = _surfels(xyz, rng.uniform(0.2, 0.6, (N_SCENE, 2)),
                     rng.uniform(0.3, 0.95, N_SCENE))
    K = spherical.spherical_intrinsics(scene[0], H, W)[0]
    k_cap = (3 if chunk == 32 else 2) * chunk
    params = RenderParams(height=H, width=W, backend="cuda", chunk=chunk,
                          tile_h=tile_h, tile_w=tile_w,
                          tile_list_capacity=k_cap)
    tiles = prepare_tiles(*scene, torch.eye(4), K, params)
    # six opaque surfels stacked 5 cm beside the ray of a pixel in the
    # middle of tile 2 (half a pixel: no tie between the filter and the
    # ellipse), wide enough to cover the whole tile
    ray = tiles.rays_t[2, p_tile // 2 + tile_w // 2].numpy().astype(
        np.float64)
    side = np.cross(ray, [0.0, 0.0, 1.0])
    centres = (ray * (1.0 + 0.05 * np.arange(N_OPAQUE))[:, None]
               + 0.05 * side / np.linalg.norm(side))
    opaque = _surfels(centres, np.full((N_OPAQUE, 2), 4.0),
                      np.full(N_OPAQUE, 0.99999))
    surf = [torch.cat([a, b]) for a, b in zip(scene, opaque)]
    F = binning.pack_features(common.pack_surfels(*surf, torch.eye(4), K))
    n = F.shape[0] - 1                                    # the pad row

    lists = tiles.lists.numpy().copy()
    counts = tiles.counts.numpy().copy()
    lists[lists == N_SCENE] = n
    counts[0] = 0
    lists[0] = n
    for t, head in ((1, []), (2, list(range(N_SCENE, n)))):
        rest = [i for i in lists[t, :counts[t]] if i not in head]
        others = rng.permutation(np.setdiff1d(np.arange(N_SCENE), rest))
        lists[t] = np.concatenate([head, rest, others])[:k_cap]
        counts[t] = k_cap
    return (F.numpy(), lists, counts, tiles.rays_t.numpy(),
            tiles.pix_t.numpy())


@functools.lru_cache(maxsize=None)
def _case(p_tile: int, chunk: int, flags: bool):
    """numpy inputs of one case and JAX's (out, tbound) on them; ``flags``
    turns on both the median and the distortion term."""
    inputs = _case_inputs(p_tile, chunk, p_tile * 1000 + chunk * 10 + flags)
    F, lists, counts, rays, pix = inputs
    Fg = pallas_raster._gather_features(jnp.asarray(F)[None],
                                        jnp.asarray(lists)[None])
    out, tbound = pallas_raster._fwd_call(
        Fg, jnp.asarray(counts), jnp.asarray(rays), jnp.asarray(pix),
        chunk=chunk, width=W, with_median=flags, with_dist=flags)
    return inputs, (np.asarray(out), np.asarray(tbound))


def _fwd_segments(F, lists, counts, rays, pix, *, chunk: int, width: int,
                  with_median: bool, with_dist: bool, seg: int = 32,
                  composited=None):
    """K1's schedule in plain PyTorch: each chunk the tile composites (the
    tile-level exit of ``kernels.raster_fwd_plain``) is cut into segments
    of ``seg`` slots.  Pass 1 reduces each segment, from T = 1, to its
    product P of (1 - alpha) and A = sum wl, D = sum wl m, N = sum wl n,
    B = sum wl (m Al_pre - Dl_pre), wl = alpha Tl; the combine runs over
    the segments in order from the carried state; the median is the depth
    of the first slot of the crossing segment (T0 > 0.5 >= T0 P) with
    T0 Tl (1 - alpha) <= 0.5, or of its last slot.  Slots past the count,
    or past ``composited`` [T] where given (K7's count trimmed to the last
    slot of non-zero opacity; the chunks reached still follow the count),
    are not composited.  Returns (out, tbound) as the plain version."""
    n_tiles, k_cap = lists.shape
    n_chunks = k_cap // chunk
    ns = chunk // seg
    n_act = kernels._n_active_chunks(counts, chunk)
    zeros = rays.new_zeros((n_tiles, rays.shape[1]))
    T, a, d, med, dist = zeros + 1.0, zeros, zeros, zeros, zeros
    n = rays.new_zeros((*zeros.shape, 3))
    tbound = rays.new_zeros((*zeros.shape, n_chunks))

    def segs(x):                              # [T, P, C] -> [T, P, ns, seg]
        return x.reshape(*x.shape[:-1], ns, seg)

    for i in range(n_chunks):
        act = (i < n_act) & (T.amax(dim=1) > common.T_EPS)
        if not bool(act.any()):
            break
        a1 = act[:, None]
        tbound[:, :, i] = torch.where(a1, T, 0.0)
        Fc = F[lists[:, i * chunk:(i + 1) * chunk].long()]
        geo = kernels._splat_geometry(Fc, rays, pix, width)
        slot = i * chunk + torch.arange(chunk)
        n_comp = counts if composited is None else composited
        alpha = torch.where((slot[None, :] < n_comp[:, None].long())[:, None],
                            geo["alpha"], 0.0)
        m = segs(geo["m"].expand_as(alpha))
        # pass 1
        Tl_after = torch.cumprod(segs(1.0 - alpha), -1)
        Tl = torch.cat([torch.ones_like(Tl_after[..., :1]),
                        Tl_after[..., :-1]], -1)
        wl = segs(alpha) * Tl
        A, D = wl.sum(-1), (wl * m).sum(-1)
        N = torch.einsum("tpsj,tksj->tpsk", wl,
                         geo["n3"].reshape(n_tiles, 3, ns, seg))
        B = (wl * (m * kernels._excl_cumsum(wl)
                   - kernels._excl_cumsum(wl * m))).sum(-1)
        # the combine, segment by segment
        Tc, ac, dc, nc_, medc, distc = T, a, d, n, med, dist
        no_med = med == 0.0
        for s in range(ns):
            T0 = Tc
            if with_dist:
                distc = distc + T0 * (ac * D[..., s] - dc * A[..., s]) \
                    + T0 * T0 * B[..., s]
            dc = dc + T0 * D[..., s]
            ac = ac + T0 * A[..., s]
            nc_ = nc_ + T0[..., None] * N[..., s, :]
            Tc = T0 * Tl_after[..., s, -1]
            if with_median:
                cross = no_med & (T0 > 0.5) & (Tc <= 0.5)
                below = T0[..., None] * Tl_after[..., s, :] <= 0.5
                below[..., -1] = True
                j = torch.argmax(below.int(), dim=-1, keepdim=True)
                medc = torch.where(cross, torch.gather(m[..., s, :], -1,
                                                       j)[..., 0], medc)
        T = torch.where(a1, Tc, T)
        a = torch.where(a1, ac, a)
        d = torch.where(a1, dc, d)
        n = torch.where(a1[..., None], nc_, n)
        med = torch.where(a1, medc, med)
        dist = torch.where(a1, distc, dist)
    out = torch.cat([d[..., None], a[..., None], n, med[..., None],
                     dist[..., None], T[..., None]], dim=-1)
    return out, tbound


def _assert_forward(out, tbound, ref_out, ref_tbound):
    """The JAX package's forward tolerances, the median as its tests hold
    it (where both cross T = 0.5)."""
    out, tbound = np.asarray(out), np.asarray(tbound)
    for c, tol in CHANNEL_TOL:
        np.testing.assert_allclose(out[..., c], ref_out[..., c], rtol=0,
                                   atol=tol, err_msg=f"channel {c}")
    np.testing.assert_allclose(tbound, ref_tbound, rtol=0, atol=2e-5)
    mo, mr = out[..., 5], ref_out[..., 5]
    both = (mo > 0) & (mr > 0)
    np.testing.assert_allclose(mo[both], mr[both], rtol=0, atol=1e-4)
    assert both.sum() >= 0.99 * (mr > 0).sum()


CASES = [(p, c, f) for p in (32, 64, 256) for c in (32, 64)
         for f in (False, True)]


def _check_case(inputs, ref):
    """What the case's hand-set tiles must show in JAX's output."""
    counts, ref_out, ref_tb = inputs[2], ref[0], ref[1]
    assert counts[0] == 0 and counts[1] == counts[2] == inputs[1].shape[1]
    assert np.all(ref_out[0, :, 7] == 1.0) and np.all(ref_tb[0] == 0.0)
    # the opaque stack ends its tile after the first chunk
    assert ref_tb[2, :, 1:].max() == 0.0 < ref_tb[1, :, 1].max()
    assert ref_out[2, :, 7].max() <= common.T_EPS


@pytest.mark.parametrize("p_tile,chunk,flags", CASES)
def test_raster_fwd_vs_pallas(p_tile, chunk, flags):
    """K1 on CPU tensors against JAX ``_fwd_call`` at P = 32, 64 and 256,
    chunk 32 (K = 3 chunks) and 64 (K = 2 chunks), with neither and with
    both of the median and the distortion term."""
    inputs, ref = _case(p_tile, chunk, flags)
    _check_case(inputs, ref)
    if flags:
        assert (ref[0][..., 5] > 0).sum() > 0.5 * ref[0][..., 5].size
    args = tuple(torch.tensor(a) for a in inputs)
    out, tbound = kernels.raster_fwd(*args, chunk=chunk, width=W,
                                     with_median=flags, with_dist=flags)
    _assert_forward(out, tbound, *ref)


@pytest.mark.parametrize("seg", [16, 32])
@pytest.mark.parametrize("p_tile,chunk,flags", CASES)
def test_segment_model_vs_plain_and_pallas(p_tile, chunk, flags, seg):
    """The segment schedule (pass-1 sums, the combine over segments, the
    median's walk of the crossing segment) against the plain version in
    float64 to 1e-9 of max|out| (the same sums regrouped), the median
    exactly, and against JAX in float32 at the forward tolerances."""
    inputs, ref = _case(p_tile, chunk, flags)
    args = tuple(torch.tensor(a) for a in inputs)
    kw = dict(chunk=chunk, width=W, with_median=flags, with_dist=flags)
    _assert_forward(*_fwd_segments(*args, seg=seg, **kw), *ref)
    a64 = [a.double() if a.is_floating_point() else a for a in args]
    m64, tb64 = _fwd_segments(*a64, seg=seg, **kw)
    p64, ptb64 = kernels.raster_fwd_plain(*a64, **kw)
    np.testing.assert_allclose(m64.numpy(), p64.numpy(), rtol=0,
                               atol=1e-9 * float(p64.abs().max()))
    np.testing.assert_array_equal(tb64.numpy() > 0, ptb64.numpy() > 0)
    np.testing.assert_allclose(tb64.numpy(), ptb64.numpy(), rtol=0,
                               atol=1e-12)
