"""Camera: one LiDAR measurement viewed as a spherical camera.

Counterpart of splatloam_tpu/model/camera.py: the model->camera transform
T_cw and the spherical intrinsics K are stored directly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    K: torch.Tensor        # [3, 3] spherical intrinsics
    T_cw: torch.Tensor     # [4, 4] model/world -> camera
    depth: torch.Tensor    # [H, W] measured range image
    normal: torch.Tensor   # [H, W, 3] measured normal image (sensor frame)
    valid: torch.Tensor    # [H, W] bool

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    @property
    def device(self) -> torch.device:
        return self.depth.device

    def with_pose(self, T_cw) -> "Camera":
        return self._replace(T_cw=torch.as_tensor(
            T_cw, dtype=torch.float32, device=self.device))


def make_camera(K, depth, normal, valid, T_wc=None, device=None) -> Camera:
    """T_wc is the camera(=frame) pose; stored inverted as T_cw.  Tensors
    land on ``device`` (default: the device of ``depth``)."""
    if device is None:
        device = depth.device if torch.is_tensor(depth) else "cpu"
    if T_wc is None:
        T_cw = np.eye(4, dtype=np.float32)
    else:
        T_cw = np.linalg.inv(np.asarray(T_wc)).astype(np.float32)

    def put(x, dtype=torch.float32):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x))     # a writable copy
        return x.to(dtype=dtype, device=device)

    return Camera(K=put(K), T_cw=put(T_cw), depth=put(depth),
                  normal=put(normal), valid=put(valid, torch.bool))
