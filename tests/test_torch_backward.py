"""The port's backward kernel K2 (``kernels.raster_bwd``) and the CPU model
of its slot-parallel schedule (``_bwd_segments`` below) against
the JAX package's ``pallas_raster._bwd_call`` on the CPU.

Inputs: a seeded scene packed by the port (features F, tile rays and
pixels at 4x16 and 2x16 tiles), hand-set tile lists with a tile of count
0, a tile of count K, and a tile whose first slots are six opaque surfels
stacked beside one pixel's ray, so its T falls under T_EPS after the
first chunk and pairs have alpha_raw >= 0.999; the forward's tbound and
outputs come from JAX ``_fwd_call`` and feed both sides, with random
cotangents.  The JAX side runs its Pallas kernels in interpret mode; on
CPU tensors the port's wrapper runs its plain version.  Tolerance 2e-3 *
max|dFg|, the repo's gradient tolerance.
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

H, W = 8, 64
N_SCENE = 300
N_OPAQUE = 6


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
def _case(tile_h: int, chunk: int, with_dist: bool):
    """numpy inputs of one case and JAX's dFg [T, K, 16] on them."""
    rng = np.random.default_rng(tile_h * 1000 + chunk * 10 + with_dist)
    theta = rng.uniform(-np.pi, np.pi, N_SCENE)
    xyz = np.stack([7 * np.cos(theta), 7 * np.sin(theta),
                    rng.uniform(-1.0, 1.5, N_SCENE)], -1)
    scene = _surfels(xyz, rng.uniform(0.2, 0.6, (N_SCENE, 2)),
                     rng.uniform(0.3, 0.95, N_SCENE))
    K = spherical.spherical_intrinsics(scene[0], H, W)[0]
    k_cap = (3 if chunk == 32 else 2) * chunk
    params = RenderParams(height=H, width=W, backend="cuda", chunk=chunk,
                          tile_h=tile_h, tile_w=16, tile_list_capacity=k_cap)
    tiles = prepare_tiles(*scene, torch.eye(4), K, params)
    # six opaque surfels stacked 5 cm beside the ray of a middle pixel of
    # tile 2 (half a pixel: no tie between the filter and the ellipse),
    # wide enough to cover the whole tile
    ray = tiles.rays_t[2, 8].numpy().astype(np.float64)
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
    g = rng.normal(size=(lists.shape[0], tile_h * 16, 8)).astype(np.float32)
    rays, pix = tiles.rays_t.numpy(), tiles.pix_t.numpy()

    Fg = pallas_raster._gather_features(jnp.asarray(F.numpy())[None],
                                        jnp.asarray(lists)[None])
    jkw = dict(chunk=chunk, width=W, with_median=False, with_dist=with_dist)
    outs, tbound = pallas_raster._fwd_call(Fg, jnp.asarray(counts),
                                           jnp.asarray(rays),
                                           jnp.asarray(pix), **jkw)
    ref = pallas_raster._bwd_call(Fg, jnp.asarray(counts), jnp.asarray(rays),
                                  jnp.asarray(pix), tbound, outs,
                                  jnp.asarray(g), **jkw)
    inputs = (F.numpy(), lists, counts, rays, pix, np.asarray(tbound),
              np.asarray(outs), g)
    return inputs, np.asarray(ref)


def _bwd_segments(F, lists, counts, rays, pix, tbound, outs, g, *,
                  chunk: int, width: int, with_dist: bool, seg: int = 32):
    """K2's schedule in plain PyTorch: each live chunk, last first, is cut
    into segments of ``seg`` slots.  Pass 1 walks each segment from T = 1
    to its product of (1 - alpha) and coefficients a = sum wl (base +
    gdist (m A - D)), and
    with the distortion term sum wl, sum wl m and b = sum wl (m Wl_pre -
    MDl_pre), wl = alpha Tl; a scan gives each segment its start T0 (from
    tbound, forward) and the strict-suffix carries after it (last first);
    pass 2 computes the rows from T_i = T0 Tl_i and exact suffix sums.
    Returns dFg [T, K, 16] as ``kernels.raster_bwd_plain``."""
    n_tiles, k_cap = lists.shape
    n_live = kernels._live_chunks(counts, tbound, chunk)
    ns = chunk // seg
    gD, gA, gN, gdist = g[..., 0:1], g[..., 1:2], g[..., 2:5], g[..., 6:7]
    A_total, D_total = outs[..., 1:2], outs[..., 0:1]
    S, W, MD = (torch.zeros_like(gD) for _ in range(3))
    dFg = F.new_zeros((n_tiles, k_cap, 16))

    def segs(x):                               # [T, P, C] -> [T, P, ns, seg]
        return x.reshape(*x.shape[:-1], ns, seg)

    def strict_suffix(x):                      # within each segment
        return kernels._strict_suffix_sum(segs(x)).reshape(x.shape)

    for i in range(k_cap // chunk - 1, -1, -1):
        a1 = (i < n_live)[:, None, None]
        if not bool(a1.any()):
            continue
        Fc = F[lists[:, i * chunk:(i + 1) * chunk].long()]
        geo = kernels._splat_geometry(Fc, rays, pix, width)
        alpha, m = geo["alpha"], geo["m"]
        base = gD * m + gA + torch.einsum("tpk,tkc->tpc", gN, geo["n3"])
        # pass 1
        one_m = segs(1.0 - alpha)
        Tl = torch.cat([torch.ones_like(one_m[..., :1]),
                        torch.cumprod(one_m, -1)[..., :-1]], -1)
        prod = Tl[..., -1] * one_m[..., -1]                   # [T, P, ns]
        wl = segs(alpha) * Tl
        q = base + gdist * (m * A_total - D_total) if with_dist else base
        a = (wl * segs(q)).sum(-1)
        sw, swm = wl.sum(-1), (wl * segs(m)).sum(-1)
        b = (wl * (segs(m) * kernels._excl_cumsum(wl)
                   - kernels._excl_cumsum(wl * segs(m)))).sum(-1)
        # the scan
        T0 = tbound[:, :, i:i + 1] * torch.cat(
            [torch.ones_like(prod[..., :1]),
             torch.cumprod(prod, -1)[..., :-1]], -1)
        after = [None] * ns
        S_n, W_n, MD_n = S, W, MD
        for s in range(ns - 1, -1, -1):
            after[s] = (S_n, W_n, MD_n)
            t0 = T0[..., s:s + 1]
            if with_dist:
                S_n = (S_n + t0 * a[..., s:s + 1]
                       + 2.0 * gdist * t0 * (MD_n * sw[..., s:s + 1]
                                             - W_n * swm[..., s:s + 1])
                       + 2.0 * gdist * t0 * t0 * b[..., s:s + 1])
                W_n = W_n + t0 * sw[..., s:s + 1]
                MD_n = MD_n + t0 * swm[..., s:s + 1]
            else:
                S_n = S_n + t0 * a[..., s:s + 1]
        S_a, W_a, MD_a = (torch.cat(x, -1)[..., None].expand(-1, -1, -1, seg)
                          .reshape(alpha.shape) for x in zip(*after))
        # pass 2
        Ti = (T0[..., None] * Tl).reshape(alpha.shape)
        w = alpha * Ti
        wm = w * m
        phi = base
        gm = w * gD
        if with_dist:
            W_suf = W_a + strict_suffix(w)
            MD_suf = MD_a + strict_suffix(wm)
            A_prev = A_total - w - W_suf
            D_prev = D_total - wm - MD_suf
            phi = phi + gdist * (m * A_prev - D_prev + MD_suf - m * W_suf)
            gm = gm + w * gdist * (A_prev - W_suf)
        S_phi = S_a + strict_suffix(w * phi)
        dF = kernels._bwd_rows(geo, rays, gN, Ti, w, phi, S_phi, gm)
        dFg[:, i * chunk:(i + 1) * chunk] = torch.where(
            a1, dF.transpose(1, 2), 0.0)
        S = torch.where(a1, S_n, S)
        W = torch.where(a1, W_n, W)
        MD = torch.where(a1, MD_n, MD)
    return dFg


def _port_args(inputs):
    return tuple(torch.tensor(a) for a in inputs)


def _assert_rows(port, ref):
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())


CASES = [(h, c, d) for h in (2, 4) for c in (32, 64) for d in (False, True)]


@pytest.mark.parametrize("tile_h,chunk,with_dist", CASES)
def test_raster_bwd_vs_pallas(tile_h, chunk, with_dist):
    """K2 on CPU tensors against JAX ``_bwd_call`` at P = 32 and 64,
    chunk 32 (K = 3 chunks) and 64 (K = 2 chunks), with and without the
    distortion term; the adversarial tiles are what the case says."""
    inputs, ref = _case(tile_h, chunk, with_dist)
    F, lists, counts, rays, pix, tbound, outs, g = _port_args(inputs)
    assert counts[0] == 0 and counts[1] == counts[2] == lists.shape[1]
    assert float(tbound[2, :, 1:].max()) <= common.T_EPS < \
        float(tbound[1, :, 1].max())
    geo = kernels._splat_geometry(F[lists[2:3, :chunk].long()], rays[2:3],
                                  pix[2:3], W)
    assert float(geo["alpha_raw"].max()) >= common.ALPHA_MAX
    dFg = kernels.raster_bwd(F, lists, counts, rays, pix, tbound, outs, g,
                             chunk=chunk, width=W, with_dist=with_dist)
    _assert_rows(dFg, ref)
    assert np.abs(ref[0]).max() == 0 and np.abs(ref[2, chunk:]).max() == 0
    assert np.abs(ref[2, :N_OPAQUE]).max() > 0


@pytest.mark.parametrize("seg", [16, 32])
@pytest.mark.parametrize("tile_h,chunk,with_dist", CASES)
def test_segment_model_vs_plain_and_pallas(tile_h, chunk, with_dist, seg):
    """The segment schedule (pass-1 coefficients, the scan over segments,
    the pass-2 reverse walk) against the plain version, in float64 to
    1e-9 of max|dFg| (the same sums regrouped), and against JAX in float32
    at the gradient tolerance."""
    inputs, ref = _case(tile_h, chunk, with_dist)
    args = _port_args(inputs)
    kw = dict(chunk=chunk, width=W, with_dist=with_dist)
    model = _bwd_segments(*args, seg=seg, **kw)
    _assert_rows(model, ref)
    a64 = [a.double() if a.is_floating_point() else a for a in args]
    m64 = _bwd_segments(*a64, seg=seg, **kw)
    p64 = kernels.raster_bwd_plain(*a64, **kw)
    np.testing.assert_allclose(m64.numpy(), p64.numpy(), rtol=0,
                               atol=1e-9 * float(p64.abs().max()))
