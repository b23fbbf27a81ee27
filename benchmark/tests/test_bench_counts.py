"""The kernels' counts on a toy pool against a brute-force count, and the
reference renderer's culling against the full (surfel, pixel) product."""
import math

import numpy as np
import pytest
import torch

from counts import peaks, raster as counts
from reference import raster


def toy_pool(n=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    ang = torch.rand(n, generator=g) * 2 * math.pi
    rad = 4 + 6 * torch.rand(n, generator=g)
    z = -1.5 + 3 * torch.rand(n, generator=g)
    xyz = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang), z], -1)
    scaling = 0.05 + 0.3 * torch.rand(n, 2, generator=g)
    quat = torch.randn(n, 4, generator=g)
    opacity = 0.05 + 0.9 * torch.rand(n, generator=g)
    K = torch.tensor([[64 / (2 * math.pi), 0, 31.0], [0, -15 / 1.2, 7.0],
                      [0, 0, 1.0]])
    return xyz, scaling, quat, opacity, torch.eye(4), K


def brute_force(xyz, scaling, quat, opacity, T_cw, K, h, w):
    """Every (surfel, pixel) pair at once, no culling."""
    f = raster.pack(xyz, scaling, quat, opacity, T_cw, K)
    order = torch.argsort(torch.where(f["visible"], f["depth"],
                                      torch.inf), stable=True)
    f = {k: v[order] for k, v in f.items()}
    rays, pix = raster.pixel_rays(K, h, w)
    a, m = raster.splat_alpha_depth(f, rays, pix, w)
    a = torch.where(f["visible"][:, None], a, 0.0)
    t_before = torch.cumprod(torch.cat([torch.ones(1, a.shape[1]),
                                        1 - a[:-1]]), 0)
    wgt = a * t_before
    alpha = wgt.sum(0)
    depth = torch.where(alpha > 0, (wgt * m).sum(0) / alpha.clamp(min=1e-30),
                        0.0)
    pairs = ((a > 0) & (t_before > raster.T_EPS)).sum()
    return alpha.reshape(h, w), depth.reshape(h, w), int(pairs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_culled_render_and_pairs_match_brute_force(seed):
    pool = toy_pool(seed=seed)
    h, w = 16, 64
    out = raster.render(*pool, h, w, count_pairs=True)
    alpha, depth, n_pairs = brute_force(*pool, h, w)
    assert n_pairs > 0
    torch.testing.assert_close(out["alpha"], alpha, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["depth"], depth, rtol=1e-4, atol=1e-4)
    assert counts.pairs(*pool, h, w) == n_pairs


def test_bytes_and_bound():
    assert counts.fwd_bytes(10, 4) == 10 * 64 + 4 * (20 + 32)
    assert counts.bwd_bytes(10, 4) == 2 * 10 * 64 + 4 * (20 + 64)
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_view_weights():
    np.testing.assert_allclose(counts.view_weights(1, 0.4), [1.0])
    np.testing.assert_allclose(counts.view_weights(4, None), [0.25] * 4)
    wts = counts.view_weights(3, 0.4)
    np.testing.assert_allclose(wts, np.array([0.144, 0.24, 0.4]) / 0.784)


@pytest.mark.parametrize("n, p", [(1, 0.4), (4, None), (5, 0.3), (7, -1.0)])
def test_view_weights_follow_the_mappers_draws(n, p):
    """Newest-first, as the mapper draws its keyframes."""
    from splatloam_tpu_torch.slam.mapper import sample_geometric_probs
    np.testing.assert_allclose(counts.view_weights(n, p),
                               sample_geometric_probs(n, p, n), rtol=1e-6)


def test_expected_per_launch_weights_views_and_iterations():
    pool = toy_pool()
    xyz, scaling, quat, opacity, T, K = pool
    one = counts.pairs(*pool, 16, 64)
    upd = dict(xyz=xyz, scaling=scaling, quat=quat, opacity=opacity,
               views=[T, T], K=[K, K], height=16, width=64, iters=10)
    c = counts.expected_per_launch([upd, dict(upd, iters=30)], 0.4)
    assert c["pairs"] == pytest.approx(one)
    assert c["surfels"] == len(xyz) and c["pixels"] == 16 * 64
