"""Preprocessor: raw point cloud -> Frame (range/normal/valid images).

Counterpart of splatloam_tpu/preprocessing.py: per-cloud spherical
intrinsics, z-buffered projection (ops.projection), normals either toward
the sensor (the paper's default, computed on the device) or by PCA over a
scipy KD-tree on the host, optional ground segmentation.  Clouds are
padded to power-of-two buckets, as in the JAX package, and each sweep
goes to the device in one copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Configuration
from .device import resolve_device
from .geometry import spherical
from .model.camera import make_camera
from .model.frame import Frame
from .ops import projection


def _preprocess_device(pts: torch.Tensor, pmask: torch.Tensor, height: int,
                       width: int, depth_min: float, depth_max: float,
                       normals: torch.Tensor | None = None):
    """Intrinsics fit + z-buffer + image gathers.

    Returns (K [3,3], depth [H,W], normal image [H,W,3], valid [H,W]).
    Without ``normals`` each point's normal is the unit vector toward the
    sensor (the paper's default).
    """
    K, _, _ = spherical.spherical_intrinsics(pts, height, width,
                                             valid=pmask)
    depth, lut, valid = projection.build_range_image(
        pts, pmask, K, height, width, depth_min, depth_max)
    if normals is None:
        norms = torch.linalg.norm(pts, dim=1, keepdim=True)
        normals = -pts / torch.clamp(norms, min=1e-12)
    normal_img = normals[torch.clamp(lut, min=0).long()]
    normal_img = torch.where(valid[..., None], normal_img,
                             torch.zeros_like(normal_img))
    return K, depth, normal_img, valid


def _bucket_size(n: int, minimum: int = 4096) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


class Preprocessor:
    """``device``: None -> cuda (raises without a GPU)."""

    def __init__(self, cfg: Configuration, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def __call__(self, cloud: np.ndarray, timestamp: float,
                 gt_pose: np.ndarray | None = None) -> Frame:
        """cloud: [N, 3] float32; gt_pose: optional [4, 4]."""
        pcfg = self.cfg.preprocessing
        cloud = np.asarray(cloud, np.float32)
        cloud = cloud[np.isfinite(cloud).all(axis=1)]
        n = len(cloud)
        padded = _bucket_size(n)
        host_normals = pcfg.enable_normal_estimation or \
            pcfg.enable_ground_segmentation
        # points, and the host's normals beside them, in one upload
        buf = np.zeros((padded, 6 if host_normals else 3), np.float32)
        buf[:n, :3] = cloud
        if host_normals:
            mask = np.arange(padded) < n
            buf[:, 3:] = self.compute_normals(buf[:, :3], mask)
        dev_buf = torch.from_numpy(buf).to(self.device)
        pmask = torch.arange(padded, device=self.device) < n
        K, depth, normal_img, valid = _preprocess_device(
            dev_buf[:, :3], pmask, pcfg.image_height, pcfg.image_width,
            float(pcfg.depth_min), float(pcfg.depth_max),
            normals=dev_buf[:, 3:] if host_normals else None)
        camera = make_camera(K=K, depth=depth, normal=normal_img,
                             valid=valid)
        frame_pose = np.eye(4) if gt_pose is None else np.asarray(gt_pose)
        return Frame(camera=camera, timestamp=timestamp,
                     world_T_frame=frame_pose)

    def compute_normals(self, cloud: np.ndarray,
                        mask: np.ndarray) -> np.ndarray:
        """Per-point normals on the host.

        Default: unit vector toward the sensor.  Optional PCA estimation
        uses a scipy KD-tree (radius-bounded KNN, oriented toward sensor).
        """
        pcfg = self.cfg.preprocessing
        norms = np.linalg.norm(cloud, axis=1, keepdims=True)
        toward = -cloud / np.maximum(norms, 1e-12)
        if not pcfg.enable_normal_estimation:
            out = toward.astype(np.float32)
            if pcfg.enable_ground_segmentation:
                out = self.segment_ground(cloud, mask, out)
            return out

        from scipy.spatial import cKDTree
        pts = cloud[mask]
        if len(pts) < 10:
            return toward.astype(np.float32)
        tree = cKDTree(pts)
        k = min(20, len(pts))
        dist, idx = tree.query(pts, k=k, distance_upper_bound=0.5)
        finite = np.isfinite(dist)
        idx_safe = np.where(finite, idx, 0)
        nbrs = pts[idx_safe]  # [M, k, 3]
        w = finite[..., None].astype(np.float32)
        cnt = np.maximum(w.sum(axis=1), 1.0)
        mean = (nbrs * w).sum(axis=1) / cnt
        centered = (nbrs - mean[:, None, :]) * w
        cov = np.einsum("mki,mkj->mij", centered, centered) / cnt[..., None]
        # smallest-eigenvector normal
        _, vecs = np.linalg.eigh(cov)
        normal = vecs[:, :, 0]
        # orient toward the sensor
        flip = np.sign(np.sum(normal * (-pts), axis=1, keepdims=True))
        flip[flip == 0] = 1.0
        normal = normal * flip
        out = toward.copy()
        out[mask] = normal
        out = out.astype(np.float32)
        if pcfg.enable_ground_segmentation:
            out = self.segment_ground(cloud, mask, out)
        return out

    def segment_ground(self, cloud: np.ndarray, mask: np.ndarray,
                       normals: np.ndarray,
                       n_sectors: int = 64, ring_m: float = 2.0,
                       dz: float = 0.15) -> np.ndarray:
        """Assign up-facing (+z) normals to ground points.

        Patchwork-style simplification: a polar (sector x ring) grid keeps
        each cell's lowest masked point as the local ground height; points
        within ``dz`` of it, in cells whose floor lies near the global
        ground level, are ground.
        """
        pts = np.asarray(cloud, np.float32)
        z = pts[:, 2]
        az = np.arctan2(pts[:, 1], pts[:, 0])
        rad = np.hypot(pts[:, 0], pts[:, 1])
        n_rings = max(int(np.ceil(rad[mask].max() / ring_m)) + 1, 1) \
            if mask.any() else 1
        sector = np.clip(((az + np.pi) / (2 * np.pi) * n_sectors)
                         .astype(np.int64), 0, n_sectors - 1)
        ring = np.clip((rad / ring_m).astype(np.int64), 0, n_rings - 1)
        cell = sector * n_rings + ring
        cell_min = np.full(n_sectors * n_rings, np.inf, np.float32)
        np.minimum.at(cell_min, cell[mask], z[mask])
        # cells whose floor is near the global ground level (rejects cells
        # whose lowest return is a wall/ledge above the ground)
        ground_z = np.percentile(z[mask], 5.0) if mask.any() else 0.0
        cell_ok = cell_min <= ground_z + 4 * dz
        ground = mask & cell_ok[cell] & (z <= cell_min[cell] + dz)
        out = normals.copy()
        out[ground] = (0.0, 0.0, 1.0)
        return out
