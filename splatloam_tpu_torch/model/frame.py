"""Frame: (camera, timestamp, estimated pose, optional GT pose).

Counterpart of splatloam_tpu/model/frame.py.  model_T_frame is the pose
estimated by the SLAM system in the current submap's frame; world_T_frame
comes from ground truth (may be None).
"""
from __future__ import annotations

import numpy as np

from .camera import Camera


class Frame:
    def __init__(self, camera: Camera, timestamp: float,
                 model_T_frame: np.ndarray | None = None,
                 world_T_frame: np.ndarray | None = None):
        self.camera = camera
        self.timestamp = float(timestamp)
        self.model_T_frame = np.eye(4, dtype=np.float64) \
            if model_T_frame is None else np.asarray(model_T_frame,
                                                     np.float64)
        self.world_T_frame = np.eye(4, dtype=np.float64) \
            if world_T_frame is None else np.asarray(world_T_frame,
                                                     np.float64)

    def camera_in_model(self) -> Camera:
        """Camera posed at the current model_T_frame estimate."""
        return self.camera.with_pose(
            np.linalg.inv(self.model_T_frame).astype(np.float32))
