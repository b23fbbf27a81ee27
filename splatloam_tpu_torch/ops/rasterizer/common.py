"""Shared math for the spherical 2D-Gaussian-surfel rasterizer.

Counterpart of splatloam_tpu/ops/rasterizer/common.py, which fixes the
contract both backends implement.  Output channels per pixel, blended
front-to-back with w_i = alpha_i * prod_{j<i} (1 - alpha_j):

  depth_sum  = sum_i w_i d_i
  alpha      = sum_i w_i
  normal_sum = sum_i w_i n_i^cam
  median     = d_i at the first i where transmittance crosses 0.5
  dist       = sum_i w_i (m_i*A_{i-1} - D_{i-1})   (2DGS distortion)

A pixel ray d meets a surfel's plane at t* = (n.p)/(n.d); local coords
(uu, vv) are dot products with the tangent axes pre-divided by the scales;
rho = min(uu^2 + vv^2, FILTER_INV_SQUARE * pixel_dist^2); alpha =
min(0.999, opacity * exp(-rho/2)), cut at 1/255 or for t* <= NEAR.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

from ...geometry import se3, spherical

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
NEAR = 0.05
T_EPS = 1e-4
# 2DGS screen-space low-pass: rho_2d = FILTER_INV_SQUARE * pixel_dist^2
FILTER_INV_SQUARE = 2.0


@dataclass
class PackedSurfels:
    """Camera-frame per-surfel features; all leading dims [N].  gu/gv are
    the tangent axes pre-divided by their scale."""
    p: torch.Tensor          # [N, 3] center, camera frame
    gu: torch.Tensor         # [N, 3] t_u / s_u
    gv: torch.Tensor         # [N, 3] t_v / s_v
    n: torch.Tensor          # [N, 3] unit normal facing the sensor
    opacity: torch.Tensor    # [N]
    depth: torch.Tensor      # [N] range of center (sort key)
    center_xy: torch.Tensor  # [N, 2] continuous pixel coords of center
    radius_px: torch.Tensor  # [N] conservative pixel radius (0 => culled)
    extent_px: torch.Tensor  # [N, 2] per-axis (x, y) pixel extents

    def map(self, fn) -> "PackedSurfels":
        return PackedSurfels(*(fn(getattr(self, f.name))
                               for f in fields(self)))


def pack_surfels(xyz: torch.Tensor, scaling: torch.Tensor,
                 rotation: torch.Tensor, opacity: torch.Tensor,
                 T_cw: torch.Tensor, K: torch.Tensor) -> PackedSurfels:
    """World(model)-frame surfel params -> camera-frame packed features.

    Differentiable in the params and in T_cw: the rasterizer's autograd
    Function sits after this, so its feature gradients reach the params
    and the pose through torch autograd here.
    """
    R_cw = T_cw[:3, :3]
    t_cw = T_cw[:3, 3]
    p = xyz @ R_cw.T + t_cw
    R = se3.quat_to_rotmat(rotation)                 # [N, 3, 3] world
    Rc = torch.einsum("ij,njk->nik", R_cw, R)        # camera frame
    s = torch.clamp(scaling, min=1e-8)
    gu = Rc[:, :, 0] / s[:, 0:1]
    gv = Rc[:, :, 1] / s[:, 1:2]
    n = Rc[:, :, 2]
    # flip normals to face the sensor; the flip is a constant for autograd
    flip = -torch.sign(torch.sum(p * n, dim=-1).detach())
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    n = n * flip[:, None]

    depth = torch.linalg.norm(p, dim=-1)
    theta = torch.atan2(p[:, 1], p[:, 0])
    phi = torch.atan2(p[:, 2], torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2))
    cx = K[0, 0] * theta + K[0, 2]
    cy = K[1, 1] * phi + K[1, 2]
    center_xy = torch.stack([cx, cy], dim=-1)

    # rigorous per-axis pixel extents for binning only (no gradients):
    # every pixel with alpha >= ALPHA_MIN has rho <= 2 ln(opacity /
    # ALPHA_MIN) through either branch of min(rho2d, rho3d); see the JAX
    # package's common.py for the derivation
    pg = p.detach()
    su = (s[:, 0:1] * Rc[:, :, 0]).detach()          # s_u * t_u
    sv = (s[:, 1:2] * Rc[:, :, 1]).detach()
    op_g = opacity.detach()
    rho_max = 2.0 * torch.log(torch.clamp(op_g, min=ALPHA_MIN * (1 + 1e-6))
                              / ALPHA_MIN)
    sig = torch.sqrt(rho_max)
    m_xy = sig * torch.sqrt(su[:, 0] ** 2 + su[:, 1] ** 2
                            + sv[:, 0] ** 2 + sv[:, 1] ** 2)
    m_z = sig * torch.sqrt(su[:, 2] ** 2 + sv[:, 2] ** 2)
    rho_cyl = torch.sqrt(pg[:, 0] ** 2 + pg[:, 1] ** 2)
    ratio = m_xy / torch.clamp(rho_cyl, min=1e-12)
    dtheta = torch.where(ratio >= 1.0, torch.full_like(ratio, math.pi),
                         torch.arcsin(torch.clamp(ratio, max=1.0)))
    phi_g = phi.detach()
    z_lo, z_hi = pg[:, 2] - m_z, pg[:, 2] + m_z
    r_lo = torch.clamp(rho_cyl - m_xy, min=0.0)
    r_hi = rho_cyl + m_xy
    dphi = torch.maximum(
        torch.maximum(torch.abs(torch.atan2(z_hi, r_lo) - phi_g),
                      torch.abs(torch.atan2(z_hi, r_hi) - phi_g)),
        torch.maximum(torch.abs(torch.atan2(z_lo, r_lo) - phi_g),
                      torch.abs(torch.atan2(z_lo, r_hi) - phi_g)))
    d2d = torch.sqrt(rho_max / FILTER_INV_SQUARE)    # px
    Kd = K.detach()
    rx = torch.maximum(torch.abs(Kd[0, 0]) * dtheta, d2d) + 1.0
    ry = torch.maximum(torch.abs(Kd[1, 1]) * dphi, d2d) + 1.0
    visible = (op_g > ALPHA_MIN) & (depth.detach() > NEAR)
    extent_px = torch.where(visible[:, None], torch.stack([rx, ry], -1),
                            0.0)
    radius_px = torch.max(extent_px, dim=-1).values
    return PackedSurfels(p=p, gu=gu, gv=gv, n=n, opacity=opacity,
                         depth=depth, center_xy=center_xy,
                         radius_px=radius_px, extent_px=extent_px)


def splat_alpha_depth(packed_cols: PackedSurfels, rays: torch.Tensor,
                      pix_xy: torch.Tensor, width: int):
    """Per-(surfel, pixel) alpha and depth for one depth-sorted chunk
    (packed_cols leading dim [C]; rays [P, 3]; pix_xy [P, 2]).

    Returns (alpha [C, P], depth [C, P]).
    """
    p, gu, gv, n = (packed_cols.p, packed_cols.gu, packed_cols.gv,
                    packed_cols.n)
    dgu = gu @ rays.T                                  # [C, P]
    dgv = gv @ rays.T
    dn = n @ rays.T
    np_ = torch.sum(n * p, dim=-1)[:, None]            # [C, 1]
    pgu = torch.sum(p * gu, dim=-1)[:, None]
    pgv = torch.sum(p * gv, dim=-1)[:, None]

    denom = torch.where(torch.abs(dn) < 1e-8, torch.full_like(dn, 1e-8), dn)
    tstar = np_ / denom
    uu = tstar * dgu - pgu
    vv = tstar * dgv - pgv
    rho3d = uu * uu + vv * vv

    # 2-D low-pass (sub-pixel anti-aliasing), azimuth-wrapped
    dx = pix_xy[None, :, 0] - packed_cols.center_xy[:, 0:1]
    dx = dx - torch.round(dx / width) * width
    dy = pix_xy[None, :, 1] - packed_cols.center_xy[:, 1:2]
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)

    use2d = rho2d < rho3d
    rho = torch.where(use2d, rho2d, rho3d)
    depth = torch.where(use2d, packed_cols.depth[:, None], tstar)

    weight = torch.exp(-0.5 * rho)
    alpha = torch.clamp(packed_cols.opacity[:, None] * weight,
                        max=ALPHA_MAX)
    ok = (tstar > NEAR) & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, 0.0)
    return alpha, depth


def pixel_grid(K: torch.Tensor, height: int, width: int):
    """Returns (rays [P,3], pix_xy [P,2]) flattened row-major."""
    rays = spherical.pixel_rays(K, height, width).reshape(-1, 3)
    u = torch.arange(width, dtype=torch.float32, device=K.device) - 0.5
    v = torch.arange(height, dtype=torch.float32, device=K.device) - 0.5
    uu = u[None, :].expand(height, width).reshape(-1)
    vv = v[:, None].expand(height, width).reshape(-1)
    return rays, torch.stack([uu, vv], dim=-1)
