"""SE(3) / quaternion primitives on torch tensors (batched).

Counterpart of splatloam_tpu/geometry/se3.py.  Quaternions are wxyz.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz quaternion (not necessarily unit) -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z),
                        2 * (x * y - w * z),
                        2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z),
                        1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y),
                        2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def standardize_quat(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def rotmat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 4] wxyz unit quaternion (branch-free
    selection of the best-conditioned of four candidates)."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs_sq = torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1)
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))

    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01],
                    dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20],
                    dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21],
                    dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2],
                    dim=-1),
    ], dim=-2)
    denom = 2.0 * torch.clamp(q_abs[..., None], min=0.1)
    cand = cand / denom

    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    out = torch.gather(cand, -2, idx)[..., 0, :]
    out = out / torch.linalg.norm(out, dim=-1, keepdim=True)
    return standardize_quat(out)


def basis_from_normal(n: torch.Tensor) -> torch.Tensor:
    """[..., 3] direction -> [..., 3, 3] rotation with n as LAST column
    (seed axis x, fallback y when near-collinear)."""
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    ex = n.new_tensor([1.0, 0.0, 0.0]).expand(n.shape)
    ey = n.new_tensor([0.0, 1.0, 0.0]).expand(n.shape)
    collinear = torch.abs(torch.abs(n[..., 0]) - 1.0) < 1e-3
    seed = torch.where(collinear[..., None], ey, ex)
    t_u = torch.linalg.cross(n, seed, dim=-1)
    t_u = t_u / torch.clamp(torch.linalg.norm(t_u, dim=-1, keepdim=True),
                            min=1e-12)
    t_v = torch.linalg.cross(n, t_u, dim=-1)
    t_v = t_v / torch.clamp(torch.linalg.norm(t_v, dim=-1, keepdim=True),
                            min=1e-12)
    return torch.stack([t_u, t_v, n], dim=-1)


def quat_from_normal(n: torch.Tensor) -> torch.Tensor:
    """[..., 3] surfel normal -> wxyz quaternion whose R has n as 3rd col."""
    return rotmat_to_quat(basis_from_normal(n))


def invert_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an SE(3) matrix [..., 4, 4]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    bottom = T.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        *top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[4,4] @ [..., 3] -> [..., 3]."""
    return pts @ T[:3, :3].T + T[:3, 3]


# ---------------------------------------------------------------------------
# se(3) exponential map (tracker update:  T <- exp(dx) @ T)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist (v, w) -> [..., 4, 4] SE(3) matrix.

    Rodrigues with Taylor branches below theta = 1e-5; the divisions of
    the branch not taken are guarded so neither yields NaN.
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    theta2 = theta * theta
    small = theta < 1e-5
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one,
                                                           theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, theta2 * theta))
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    # the last row of eye(4), made on the device: no host-to-device copy,
    # so the tracker's loop runs with no synchronization
    bottom = torch.eye(4, dtype=xi.dtype, device=xi.device)[3:].expand(
        *top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)
