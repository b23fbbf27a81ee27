"""Z-buffered spherical projection: point cloud -> range/LUT images.

Counterpart of splatloam_tpu/ops/projection.py: two scatter-min passes,
the first over ranges, the second over the point index of the range-tie
winners (smallest index wins, so the LUT is deterministic).
"""
from __future__ import annotations

import torch

from ..geometry import spherical

INT32_MAX = 2 ** 31 - 1


def build_range_image(points: torch.Tensor, point_mask: torch.Tensor,
                      K: torch.Tensor, height: int, width: int,
                      depth_min: float, depth_max: float):
    """Project [N, 3] points into an (H, W) spherical z-buffer.

    Returns depth [H, W] f32 (0 where empty), lut [H, W] i32 (index of
    the winning point, -1 if empty) and valid [H, W] bool.
    """
    x, y, rng = spherical.project_points(K, points)
    u = torch.remainder(spherical.pixel_index(x), width)
    v = spherical.pixel_index(y)

    ok = (point_mask & (rng > depth_min) & (rng <= depth_max)
          & (v >= 0) & (v < height))
    v = torch.clamp(v, 0, height - 1)
    flat = (v * width + u).long()

    inf = float("inf")
    r_scatter = torch.where(ok, rng.float(), torch.full_like(rng, inf))
    zmin = torch.full((height * width,), inf, dtype=torch.float32,
                      device=points.device)
    zmin = zmin.scatter_reduce(0, flat, r_scatter, "amin")

    winner = ok & (r_scatter <= zmin[flat])
    idx = torch.arange(points.shape[0], dtype=torch.int64,
                       device=points.device)
    idx_scatter = torch.where(winner, idx, torch.full_like(idx, INT32_MAX))
    lut = torch.full((height * width,), INT32_MAX, dtype=torch.int64,
                     device=points.device)
    lut = lut.scatter_reduce(0, flat, idx_scatter, "amin")

    valid = torch.isfinite(zmin) & (lut != INT32_MAX)
    depth = torch.where(valid, zmin, torch.zeros_like(zmin))
    lut = torch.where(valid, lut, torch.full_like(lut, -1))
    return (depth.reshape(height, width),
            lut.to(torch.int32).reshape(height, width),
            valid.reshape(height, width))
