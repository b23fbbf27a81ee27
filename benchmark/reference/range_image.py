"""The plain reference of preprocessing: a sweep's spherical range image,
in NumPy float64.

The semantics the port's ``preprocessing.Preprocessor`` implements
(Splat-LOAM's spherical projection), written out again from the sweep:
the intrinsics fit to the sweep's elevation extent (azimuth spans the
circle; row 0 holds the highest return), a point (x, y, z) falls on
pixel (floor(fy * atan2(z, |xy|) + cy + 1), floor(fx * atan2(y, x) + cx
+ 1) mod W), only points with depth_min < range <= depth_max count, and
each pixel keeps its nearest point.

``tf32`` computes the same in TF32, the precision below the float32 the
port states: every coordinate rounded to TF32's 10-bit mantissa first.
It is the control that the comparison has to fail.
"""
from __future__ import annotations

import numpy as np


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest on TF32's 10 mantissa bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def intrinsics(cloud: np.ndarray, height: int, width: int) -> np.ndarray:
    """[3, 3] spherical intrinsics fit to the cloud's elevation extent."""
    p = np.asarray(cloud, np.float64)
    phi = np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1]))
    phi_min, phi_max = phi.min(), phi.max()
    vfov = max(phi_max - phi_min, 1e-6)
    fx = width / (2 * np.pi)
    fy = -(height - 1) / vfov
    return np.array([[fx, 0.0, width / 2.0 - 1.0],
                     [0.0, fy, -0.5 - fy * phi_max],
                     [0.0, 0.0, 1.0]])


def range_image(cloud: np.ndarray, height: int, width: int,
                depth_min: float, depth_max: float, tf32: bool = False,
                points: bool = False):
    """-> (depth [H, W] float64, 0 where empty; valid [H, W] bool;
    K [3, 3]), and with ``points`` the point each pixel kept [H, W, 3]
    (0 where empty) last."""
    cloud = np.asarray(cloud, np.float32)
    cloud = cloud[np.isfinite(cloud).all(axis=1)]
    if tf32:
        cloud = round_tf32(cloud)
    p = cloud.astype(np.float64)
    K = intrinsics(p, height, width)
    theta = np.arctan2(p[:, 1], p[:, 0])
    phi = np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1]))
    rng = np.linalg.norm(p, axis=1)
    u = np.mod(np.floor(K[0, 0] * theta + K[0, 2] + 1.0), width)
    v = np.floor(K[1, 1] * phi + K[1, 2] + 1.0)
    ok = (rng > depth_min) & (rng <= depth_max) & (v >= 0) & (v < height)
    flat = (v[ok] * width + u[ok]).astype(np.int64)
    depth = np.full(height * width, np.inf)
    np.minimum.at(depth, flat, rng[ok])
    valid = np.isfinite(depth)
    depth[~valid] = 0.0
    out = (depth.reshape(height, width), valid.reshape(height, width), K)
    if not points:
        return out
    # the nearest point of each pixel: the first of the pixel's run when
    # sorted by pixel, then by range
    order = np.lexsort((rng[ok], flat))
    first = np.r_[True, flat[order][1:] != flat[order][:-1]]
    keep = order[first]
    pts = np.zeros((height * width, 3))
    pts[flat[keep]] = p[ok][keep]
    return (*out, pts.reshape(height, width, 3))


def surface_normals(pts: np.ndarray, valid: np.ndarray,
                    max_step: float = 0.1):
    """-> (unit normals [H, W, 3] of the measured surface, from the
    neighbouring pixels' points (azimuth wraps), facing the sensor;
    where [H, W] bool: the pixels whose four neighbours are measured and
    lie within ``max_step`` of its range)."""
    rng = np.linalg.norm(pts, axis=-1)
    left, right = np.roll(pts, 1, axis=1), np.roll(pts, -1, axis=1)
    up = np.concatenate([pts[:1], pts[:-1]])
    down = np.concatenate([pts[1:], pts[-1:]])
    n = np.cross(right - left, down - up)
    norm = np.linalg.norm(n, axis=-1)
    where = valid.copy()
    where[0] = where[-1] = False
    for nb, nv in ((left, np.roll(valid, 1, axis=1)),
                   (right, np.roll(valid, -1, axis=1)),
                   (up, np.concatenate([valid[:1], valid[:-1]])),
                   (down, np.concatenate([valid[1:], valid[-1:]]))):
        step = np.abs(np.linalg.norm(nb, axis=-1) - rng)
        where &= nv & (step <= max_step * np.maximum(rng, 1e-12))
    where &= norm > 0
    n = n / np.where(norm > 0, norm, 1.0)[..., None]
    n = np.where((np.sum(n * pts, -1) > 0)[..., None], -n, n)
    return n, where


def mismatch(depth, valid, ref_depth, ref_valid, rel: float = 1e-5) -> float:
    """Share of the pixels whose validity, or whose depth beyond ``rel``
    of the reference's, differs from the reference's (another point won
    the pixel, or it was measured otherwise)."""
    depth = np.asarray(depth, np.float64)
    differs = (np.asarray(valid) != ref_valid) | (
        ref_valid & (np.abs(depth - ref_depth) > rel * ref_depth))
    return float(differs.mean())
