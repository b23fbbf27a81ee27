"""Spherical (range-image) camera model on torch tensors.

Counterpart of splatloam_tpu/geometry/spherical.py: a pixel (u, v) has
angles [theta, phi] = K^-1 [u - 0.5, v - 0.5, 1] and ray
[cos(theta)cos(phi), sin(theta)cos(phi), sin(phi)]; a point p projects to
x = fx*atan2(p_y, p_x) + cx, y = fy*atan2(p_z, |p_xy|) + cy.
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def angles_of_points(points: torch.Tensor):
    """[..., 3] -> (theta, phi, range)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rxy = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)
    phi = torch.atan2(z, rxy)
    rng = torch.sqrt(x * x + y * y + z * z)
    return theta, phi, rng


def ray_of_angles(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(theta, phi) -> unit ray [..., 3]."""
    c0, c1 = torch.cos(theta), torch.cos(phi)
    s0, s1 = torch.sin(theta), torch.sin(phi)
    return torch.stack([c0 * c1, s0 * c1, s1], dim=-1)


def spherical_intrinsics(cloud: torch.Tensor, height: int, width: int,
                         valid: torch.Tensor | None = None):
    """Fit K to the elevation extent of one cloud (azimuth spans the full
    circle; row 0 = max elevation).  Returns (K [3,3] f32, vfov, hfov)."""
    theta, phi, rng = angles_of_points(cloud)
    if valid is None:
        valid = rng > 1e-6
    big = torch.tensor(float("inf"), dtype=phi.dtype, device=phi.device)
    phi_min = torch.min(torch.where(valid, phi, big))
    phi_max = torch.max(torch.where(valid, phi, -big))
    vfov = torch.clamp(phi_max - phi_min, min=1e-6)
    hfov = torch.tensor(TWO_PI, dtype=phi.dtype, device=phi.device)

    # pixel u has continuous coordinate u - 0.5, so the azimuth circle maps
    # onto [-1, W-1) and the elevation extremes land on rows 0 and H-1
    fx = width / hfov
    cx = width / 2.0 - 1.0
    fy = -(height - 1) / vfov
    cy = -0.5 - fy * phi_max
    K = torch.zeros((3, 3), dtype=torch.float32, device=cloud.device)
    K[0, 0] = fx
    K[0, 2] = cx
    K[1, 1] = fy
    K[1, 2] = cy
    K[2, 2] = 1.0
    return K, vfov, hfov


def pixel_index(coord: torch.Tensor) -> torch.Tensor:
    """Continuous coordinate -> integer pixel index (floor(coord + 1))."""
    return torch.floor(coord + 1.0).to(torch.int32)


def project_points(K: torch.Tensor, points: torch.Tensor):
    """[..., 3] sensor-frame points -> (x, y, range) continuous coords."""
    theta, phi, rng = angles_of_points(points)
    x = K[0, 0] * theta + K[0, 2]
    y = K[1, 1] * phi + K[1, 2]
    return x, y, rng


def pixel_angles(K: torch.Tensor, height: int, width: int):
    """Per-pixel-center (theta, phi), each [H, W]."""
    u = torch.arange(width, dtype=torch.float32, device=K.device)
    v = torch.arange(height, dtype=torch.float32, device=K.device)
    theta = (u - 0.5 - K[0, 2]) / K[0, 0]
    phi = (v - 0.5 - K[1, 2]) / K[1, 1]
    return (theta[None, :].expand(height, width),
            phi[:, None].expand(height, width))


def pixel_rays(K: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H, W, 3] unit ray directions through every pixel center."""
    theta, phi = pixel_angles(K, height, width)
    return ray_of_angles(theta, phi)


def depth_to_points(depth: torch.Tensor, K: torch.Tensor,
                    T_wc: torch.Tensor | None = None) -> torch.Tensor:
    """Back-project an [H, W] range image to [H, W, 3] points (moved to
    world coordinates by ``T_wc`` when given)."""
    height, width = depth.shape[-2], depth.shape[-1]
    rays = pixel_rays(K, height, width)
    pts = depth[..., None] * rays
    if T_wc is not None:
        pts = pts @ T_wc[:3, :3].T + T_wc[:3, 3]
    return pts


def depth_to_normal(depth: torch.Tensor, K: torch.Tensor,
                    T_wc: torch.Tensor | None = None) -> torch.Tensor:
    """Normal map from central differences of back-projected points,
    normalized, zero on the 1-pixel border."""
    pts = depth_to_points(depth, K, T_wc)  # [H, W, 3]
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    # cross(dy, dx) orients normals toward the sensor (fy < 0)
    n = torch.linalg.cross(dy, dx, dim=-1)
    # double-where safe normalize: x / ||x|| has a NaN jacobian at exactly
    # degenerate pixels, which poisons gradients even under zero cotangents
    norm2 = torch.sum(n * n, dim=-1, keepdim=True)
    degenerate = norm2 <= 1e-24
    n_safe = torch.where(degenerate, n.new_tensor([0.0, 0.0, 1.0]), n)
    n_safe = n_safe / torch.sqrt(
        torch.sum(n_safe * n_safe, dim=-1, keepdim=True))
    n = torch.where(degenerate, torch.zeros_like(n_safe), n_safe)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def depth_gradient(depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Log-depth gradient magnitude with validity masking, [H, W]."""
    log_d = torch.where(depth > 0, torch.log(torch.clamp(depth, min=1e-12)),
                        torch.zeros_like(depth))
    valid = valid.to(torch.bool)
    dx = log_d[2:, 1:-1] - log_d[:-2, 1:-1]
    dx = dx * (valid[2:, 1:-1] & valid[:-2, 1:-1])
    dy = log_d[1:-1, 2:] - log_d[1:-1, :-2]
    dy = dy * (valid[1:-1, 2:] & valid[1:-1, :-2])
    grad = torch.sqrt(dx * dx + dy * dy)
    return torch.nn.functional.pad(grad, (1, 1, 1, 1))
