"""Device half of the preprocessor: point cloud -> range/normal/valid images.

Counterpart of splatloam_tpu/preprocessing.py:_preprocess_device.  The
host-side ``Preprocessor`` (bucket padding, optional PCA normals, ground
segmentation) is not ported yet.
"""
from __future__ import annotations

import torch

from .geometry import spherical
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
