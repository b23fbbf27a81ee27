"""Host-side (numpy) rotation helpers for trajectory I/O.

The port's own copy of splatloam_tpu/io/rotations.py (numpy only).
Quaternions here are wxyz unless suffixed otherwise.
"""
from __future__ import annotations

import numpy as np


def quat_wxyz_from_xyzw(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    return np.concatenate([q[..., 3:4], q[..., 0:3]], axis=-1)


def rotmat_from_quat(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def quat_from_rotmat(R: np.ndarray) -> np.ndarray:
    """Shepperd's method, wxyz with non-negative w."""
    R = np.asarray(R, np.float64)
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = np.array([0.25 * s,
                      (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s])
    elif m00 >= m11 and m00 >= m22:
        s = 2.0 * np.sqrt(1.0 + m00 - m11 - m22)
        q = np.array([(R[2, 1] - R[1, 2]) / s,
                      0.25 * s,
                      (R[0, 1] + R[1, 0]) / s,
                      (R[0, 2] + R[2, 0]) / s])
    elif m11 >= m22:
        s = 2.0 * np.sqrt(1.0 + m11 - m00 - m22)
        q = np.array([(R[0, 2] - R[2, 0]) / s,
                      (R[0, 1] + R[1, 0]) / s,
                      0.25 * s,
                      (R[1, 2] + R[2, 1]) / s])
    else:
        s = 2.0 * np.sqrt(1.0 + m22 - m00 - m11)
        q = np.array([(R[1, 0] - R[0, 1]) / s,
                      (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s,
                      0.25 * s])
    q = q / np.linalg.norm(q)
    return -q if q[0] < 0 else q


def transform_from_pq(pq: np.ndarray) -> np.ndarray:
    """[x y z qw qx qy qz] -> 4x4 matrix."""
    T = np.eye(4)
    T[:3, 3] = pq[:3]
    T[:3, :3] = rotmat_from_quat(pq[3:7])
    return T


def orthonormalize(R: np.ndarray) -> np.ndarray:
    """Project onto SO(3) via SVD (ref writers' norm_matrix usage)."""
    U, _, Vt = np.linalg.svd(R)
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    return U @ D @ Vt
