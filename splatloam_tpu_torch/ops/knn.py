"""Approximate 3-nearest-neighbour mean squared distance.

Counterpart of splatloam_tpu/ops/knn.py: Morton-order spatial sort, then a
+-window candidate search (the heuristic of the upstream ``distCUDA2``
kernel), plus the exact all-pairs oracle for small inputs.
"""
from __future__ import annotations

import torch

_BITS = 10  # 10 bits/axis -> 30-bit Morton codes, fits int32
INT32_MAX = 2 ** 31 - 1


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits of x (int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N] int32 Morton codes; masked-out points sort last."""
    inf = float("inf")
    lo = torch.min(torch.where(mask[:, None], xyz, inf), dim=0).values
    hi = torch.max(torch.where(mask[:, None], xyz, -inf), dim=0).values
    scale = (2.0 ** _BITS - 1.0) / torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((xyz - lo) * scale, 0.0, 2.0 ** _BITS - 1.0)
    q = q.to(torch.int32)
    code = (_spread_bits(q[:, 0])
            | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))
    return torch.where(mask, code, torch.full_like(code, INT32_MAX))


def _mean_of_k_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of each row's k smallest finite entries (0 when none)."""
    neg_top = torch.topk(-d2, k, dim=-1).values
    valid_nb = torch.isfinite(neg_top)
    total = torch.sum(torch.where(valid_nb, -neg_top,
                                  torch.zeros_like(neg_top)), dim=-1)
    return total / torch.clamp(valid_nb.sum(-1), min=1).to(d2.dtype)


def mean_sq_dist_knn(xyz: torch.Tensor, mask: torch.Tensor | None = None,
                     window: int = 16, k: int = 3) -> torch.Tensor:
    """Mean squared distance to the k nearest neighbours among the
    +-window Morton-order neighbours; [N] f32, masked points get 0."""
    n = xyz.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=xyz.device)
    order = torch.sort(morton_codes(xyz, mask), stable=True).indices
    pts = xyz[order]
    msk = mask[order]

    inf = float("inf")
    pos = torch.arange(n, device=xyz.device)
    cand = []
    for off in range(-window, window + 1):
        if off == 0:
            continue
        rolled = torch.roll(pts, -off, dims=0)
        rolled_ok = torch.roll(msk, -off, dims=0)
        in_range = (pos + off >= 0) & (pos + off < n)
        d2 = torch.sum((pts - rolled) ** 2, dim=-1)
        cand.append(torch.where(in_range & rolled_ok & msk, d2, inf))
    mean_d2 = _mean_of_k_smallest(torch.stack(cand, dim=-1), k)
    out = torch.zeros((n,), dtype=torch.float32, device=xyz.device)
    out[order] = torch.where(msk, mean_d2, torch.zeros_like(mean_d2))
    return out


def mean_sq_dist_knn_exact(xyz: torch.Tensor,
                           mask: torch.Tensor | None = None,
                           k: int = 3) -> torch.Tensor:
    """Exact O(N^2) oracle (use for N up to a few thousand)."""
    n = xyz.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=xyz.device)
    diff = xyz[:, None, :] - xyz[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    inf = float("inf")
    eye = torch.eye(n, dtype=torch.bool, device=xyz.device)
    d2 = torch.where(eye, inf, d2)
    d2 = torch.where(mask[None, :], d2, inf)
    mean_d2 = _mean_of_k_smallest(d2, k)
    return torch.where(mask, mean_d2, torch.zeros_like(mean_d2))
