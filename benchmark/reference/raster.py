"""The plain reference of the rasterizer: 2D Gaussian surfels composited
front to back through a spherical (range-image) camera, in plain PyTorch.

A frozen copy of the math that ``splatloam_tpu_torch/ops/rasterizer/
common.py`` states (the port's contract, Splat-LOAM's 2DGS renderer):
the surfel's tangent frame from its quaternion, the ray-plane hit t* =
(n.p)/(n.d), rho = min(uu^2 + vv^2, 2 * pixel_dist^2), alpha =
min(0.999, opacity * exp(-rho / 2)), cut below 1/255 or for t* <= 0.05,
depth-sorted compositing with w_i = alpha_i * prod_{j<i}(1 - alpha_j).
It imports nothing of the port: the port's plain versions are not the
yardstick.

Work is split into blocks of pixels, each composited against the surfels
whose conservative pixel extent (the same bound as the contract's)
reaches it; within a block every (surfel, pixel) pair is evaluated and
composited in depth order with no transmittance cut-off, as the
contract's golden renderer does.  ``count_pairs`` reports per pixel the
pairs that compositing needs: alpha > 0 while the transmittance before
the surfel is above T_EPS.

``tf32``: matrix products in TF32 (the precision below the float32 the
port states) and the inputs rounded to TF32's 10-bit mantissa: the
control that the comparison has to fail.
"""
from __future__ import annotations

import math

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
NEAR = 0.05
T_EPS = 1e-4
FILTER_INV_SQUARE = 2.0
BLOCK_H, BLOCK_W = 8, 64


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().to(torch.float32).view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def pixel_rays(K: torch.Tensor, height: int, width: int):
    """(rays [H*W, 3], pixel coordinates [H*W, 2]) row-major: pixel (v, u)
    has continuous coordinates (u - 0.5, v - 0.5) and angles
    theta = (u - 0.5 - cx) / fx, phi = (v - 0.5 - cy) / fy."""
    dev = K.device
    u = torch.arange(width, dtype=torch.float32, device=dev) - 0.5
    v = torch.arange(height, dtype=torch.float32, device=dev) - 0.5
    theta = ((u - K[0, 2]) / K[0, 0])[None, :].expand(height, width)
    phi = ((v - K[1, 2]) / K[1, 1])[:, None].expand(height, width)
    rays = torch.stack([torch.cos(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.cos(phi),
                        torch.sin(phi)], -1).reshape(-1, 3)
    pix = torch.stack([u[None, :].expand(height, width),
                       v[:, None].expand(height, width)], -1).reshape(-1, 2)
    return rays, pix


def pack(xyz, scaling, quat, opacity, T_cw, K) -> dict:
    """Camera-frame features of each surfel and its pixel extent."""
    R_cw, t_cw = T_cw[:3, :3], T_cw[:3, 3]
    p = xyz @ R_cw.T + t_cw
    Rc = torch.matmul(R_cw[None], quat_to_rotmat(quat))
    s = torch.clamp(scaling, min=1e-8)
    gu = Rc[:, :, 0] / s[:, 0:1]
    gv = Rc[:, :, 1] / s[:, 1:2]
    n = Rc[:, :, 2]
    flip = -torch.sign(torch.sum(p * n, dim=-1))
    n = n * torch.where(flip == 0, torch.ones_like(flip), flip)[:, None]
    depth = torch.linalg.norm(p, dim=-1)
    theta = torch.atan2(p[:, 1], p[:, 0])
    rxy2 = torch.clamp(p[:, 0] ** 2 + p[:, 1] ** 2, min=1e-30)
    phi = torch.atan2(p[:, 2], torch.sqrt(rxy2))
    center = torch.stack([K[0, 0] * theta + K[0, 2],
                          K[1, 1] * phi + K[1, 2]], -1)
    # every pixel with alpha >= ALPHA_MIN lies within these extents
    su = s[:, 0:1] * Rc[:, :, 0]
    sv = s[:, 1:2] * Rc[:, :, 1]
    rho_max = 2.0 * torch.log(torch.clamp(opacity, min=ALPHA_MIN * (1 + 1e-6))
                              / ALPHA_MIN)
    sig = torch.sqrt(rho_max)
    m_xy = sig * torch.sqrt(su[:, 0] ** 2 + su[:, 1] ** 2 + sv[:, 0] ** 2
                            + sv[:, 1] ** 2)
    m_z = sig * torch.sqrt(su[:, 2] ** 2 + sv[:, 2] ** 2)
    rho_cyl = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
    ratio = m_xy / torch.clamp(rho_cyl, min=1e-12)
    dtheta = torch.where(ratio >= 1.0, torch.full_like(ratio, math.pi),
                         torch.arcsin(torch.clamp(ratio, max=1.0)))
    z_lo, z_hi = p[:, 2] - m_z, p[:, 2] + m_z
    r_lo = torch.clamp(rho_cyl - m_xy, min=0.0)
    r_hi = rho_cyl + m_xy
    dphi = torch.stack([torch.abs(torch.atan2(z, r) - phi)
                        for z in (z_lo, z_hi) for r in (r_lo, r_hi)]).amax(0)
    d2d = torch.sqrt(rho_max / FILTER_INV_SQUARE)
    rx = torch.maximum(torch.abs(K[0, 0]) * dtheta, d2d) + 1.0
    ry = torch.maximum(torch.abs(K[1, 1]) * dphi, d2d) + 1.0
    visible = (opacity > ALPHA_MIN) & (depth > NEAR)
    return dict(p=p, gu=gu, gv=gv, n=n, opacity=opacity, depth=depth,
                center=center, rx=rx, ry=ry, visible=visible)


def splat_alpha_depth(f: dict, rays, pix, width: int):
    """alpha [C, P] and depth [C, P] of surfels ``f`` (leading dim C) at
    pixels (rays [P, 3], pix [P, 2])."""
    p, gu, gv, n = f["p"], f["gu"], f["gv"], f["n"]
    dgu, dgv, dn = gu @ rays.T, gv @ rays.T, n @ rays.T
    np_ = torch.sum(n * p, -1)[:, None]
    pgu = torch.sum(p * gu, -1)[:, None]
    pgv = torch.sum(p * gv, -1)[:, None]
    dn = torch.where(torch.abs(dn) < 1e-8, torch.full_like(dn, 1e-8), dn)
    tstar = np_ / dn
    uu = tstar * dgu - pgu
    vv = tstar * dgv - pgv
    rho3d = uu * uu + vv * vv
    dx = pix[None, :, 0] - f["center"][:, 0:1]
    dx = dx - torch.round(dx / width) * width
    dy = pix[None, :, 1] - f["center"][:, 1:2]
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use2d = rho2d < rho3d
    rho = torch.where(use2d, rho2d, rho3d)
    depth = torch.where(use2d, f["depth"][:, None], tstar)
    alpha = torch.clamp(f["opacity"][:, None] * torch.exp(-0.5 * rho),
                        max=ALPHA_MAX)
    alpha = torch.where((tstar > NEAR) & (alpha >= ALPHA_MIN), alpha, 0.0)
    return alpha, depth


def render(xyz, scaling, quat, opacity, T_cw, K, height: int, width: int,
           tf32: bool = False, count_pairs: bool = False,
           normals: bool = False) -> dict:
    """-> {"alpha", "depth" (expected depth, 0 where alpha is 0), with
    ``count_pairs`` "pairs", and with ``normals`` "normal" (the surfels'
    normals in the camera frame, facing it, composited like depth and not
    normalised: [H, W, 3])}, each [H, W] otherwise.  Surfel parameters
    are activated (scales, a quaternion, opacity in (0, 1)) in the frame
    that T_cw maps to the camera."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        if tf32:
            xyz, scaling, quat, opacity, T_cw = map(
                round_tf32, (xyz, scaling, quat, opacity, T_cw))
        with torch.no_grad():
            return _render(xyz, scaling, quat, opacity, T_cw, K, height,
                           width, count_pairs, normals)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _render(xyz, scaling, quat, opacity, T_cw, K, height, width,
            count_pairs, normals):
    f = pack(xyz, scaling, quat, opacity, T_cw, K)
    keep = torch.nonzero(f["visible"]).reshape(-1)
    order = keep[torch.argsort(f["depth"][keep], stable=True)]
    f = {k: v[order] for k, v in f.items()}
    rays, pix = pixel_rays(K, height, width)
    dev = xyz.device
    alpha_img = torch.zeros((height, width), device=dev)
    depth_img = torch.zeros((height, width), device=dev)
    pairs_img = torch.zeros((height, width), dtype=torch.int64, device=dev)
    normal_img = torch.zeros((height * width, 3), device=dev)
    for v0 in range(0, height, BLOCK_H):
        for u0 in range(0, width, BLOCK_W):
            bh, bw = min(BLOCK_H, height - v0), min(BLOCK_W, width - u0)
            rows = torch.arange(v0, v0 + bh, device=dev)
            cols = torch.arange(u0, u0 + bw, device=dev)
            idx = (rows[:, None] * width + cols[None, :]).reshape(-1)
            # the block's pixel coordinates span [u0 - .5, u0 + bw - 1.5]
            cu = u0 - 0.5 + (bw - 1) / 2
            cv = v0 - 0.5 + (bh - 1) / 2
            du = f["center"][:, 0] - cu
            du = torch.abs(du - torch.round(du / width) * width)
            dv = torch.abs(f["center"][:, 1] - cv)
            hit = torch.nonzero((du <= f["rx"] + (bw - 1) / 2)
                                & (dv <= f["ry"] + (bh - 1) / 2)).reshape(-1)
            if len(hit) == 0:
                continue
            fb = {k: v[hit] for k, v in f.items()}
            a, m = splat_alpha_depth(fb, rays[idx], pix[idx], width)
            log_t = torch.log1p(-a)
            t_before = torch.exp(torch.cumsum(log_t, 0) - log_t)
            w = a * t_before
            alpha = w.sum(0)
            dsum = (w * m).sum(0)
            alpha_img.view(-1)[idx] = alpha
            depth_img.view(-1)[idx] = torch.where(
                alpha > 0, dsum / torch.where(alpha > 0, alpha, 1.0), 0.0)
            if count_pairs:
                pairs_img.view(-1)[idx] = ((a > 0) & (t_before > T_EPS)
                                           ).sum(0)
            if normals:
                normal_img[idx] = w.T @ fb["n"]
    out = {"alpha": alpha_img, "depth": depth_img}
    if count_pairs:
        out["pairs"] = pairs_img
    if normals:
        out["normal"] = normal_img.reshape(height, width, 3)
    return out
