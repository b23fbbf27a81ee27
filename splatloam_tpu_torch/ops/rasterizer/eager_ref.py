"""Golden O(N*P) spherical surfel rasterizer in eager PyTorch.

Counterpart of splatloam_tpu/ops/rasterizer/jnp_ref.py: no spatial
culling, a Python loop over depth-sorted chunks, closed-form compositing
inside a chunk (exclusive cumsum of log1p(-alpha)), gradients from
autograd (pose gradients through ``pack_surfels``).  It is the port's CPU
oracle and the explicit ``backend="eager"``; "auto" never picks it.
"""
from __future__ import annotations

import torch

from . import common


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def rasterize_eager(xyz, scaling, rotation, opacity, T_cw, K,
                    height: int, width: int, chunk: int = 256) -> dict:
    """Returns the dict of channels (see common.py) + radii [N]."""
    n_surfels = xyz.shape[0]
    packed = common.pack_surfels(xyz, scaling, rotation, opacity, T_cw, K)
    rays, pix_xy = common.pixel_grid(K, height, width)
    n_pix = height * width

    # depth-sort: culled surfels (radius 0) sort to the back with alpha 0
    sort_depth = torch.where(packed.radius_px > 0, packed.depth.detach(),
                             float("inf"))
    order = torch.sort(sort_depth, stable=True).indices
    packed_sorted = packed.map(lambda a: a[order])

    dev, dtype = xyz.device, xyz.dtype
    T = torch.ones((n_pix,), dtype=dtype, device=dev)
    depth_sum = torch.zeros((n_pix,), dtype=dtype, device=dev)
    alpha_sum = torch.zeros((n_pix,), dtype=dtype, device=dev)
    normal_sum = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
    dist_sum = torch.zeros((n_pix,), dtype=dtype, device=dev)
    med_val = torch.zeros((n_pix,), dtype=dtype, device=dev)
    med_found = torch.zeros((n_pix,), dtype=torch.bool, device=dev)
    for c0 in range(0, n_surfels, chunk):
        cols = packed_sorted.map(lambda a: a[c0:c0 + chunk])
        a, m = common.splat_alpha_depth(cols, rays, pix_xy, width)  # [C,P]
        log_t = torch.log1p(-a)
        t_within = torch.exp(_exclusive_cumsum(log_t, dim=0))
        w = a * t_within * T[None, :]

        # distortion: w_i * (m_i * A_prev - D_prev), prefixes incl. carry
        a_prev = alpha_sum[None, :] + _exclusive_cumsum(w, dim=0)
        d_prev = depth_sum[None, :] + _exclusive_cumsum(w * m, dim=0)
        dist_sum = dist_sum + torch.sum(w * (m * a_prev - d_prev), dim=0)

        depth_sum = depth_sum + torch.sum(w * m, dim=0)
        alpha_sum = alpha_sum + torch.sum(w, dim=0)
        normal_sum = normal_sum + torch.einsum("cp,ck->pk", w, cols.n)

        # median: first surfel where transmittance crosses 0.5
        t_before = T[None, :] * t_within
        t_after = t_before * (1.0 - a)
        crossing = (t_before > 0.5) & (t_after <= 0.5) & (a > 0)
        any_cross = torch.any(crossing, dim=0)
        first = torch.argmax(crossing.to(torch.int8), dim=0)
        d_at = torch.gather(m, 0, first[None, :])[0]
        med_val = torch.where(~med_found & any_cross, d_at, med_val)
        med_found = med_found | any_cross

        T = T * torch.exp(torch.sum(log_t, dim=0))

    shape = (height, width)
    return {
        "depth_sum": depth_sum.reshape(shape),
        "alpha": alpha_sum.reshape(shape),
        "normal_sum": normal_sum.reshape(shape + (3,)),
        "median": med_val.reshape(shape),
        "dist": dist_sum.reshape(shape),
        "radii": packed.radius_px,
        "final_T": T.reshape(shape),
    }
