"""rerun.io backend (ref utils/logging_backends/rerun_logging.py:12-121).

The port's copy of splatloam_tpu/logging_backends/rerun_logging.py.  Only
importable when the optional rerun-sdk is installed.  Reproduces the
reference viewer: a fixed blueprint (2D strip of depth_in / depth /
normals / densify_mask / depth_l1 beside the 3D world view), surfels as
solid ellipsoids colored by their normal axis, and spawn / serve-gRPC /
connect-gRPC startup modes.  Tensors are read back to the host with
``.detach().cpu().numpy()``.
"""
from __future__ import annotations

import numpy as np
import rerun as rr
import torch

from ..logging_utils import get_logger
from . import to_numpy

logger = get_logger("rerun")


def _blueprint():
    """Fixed viewer layout (ref rerun_logging.py:16-31)."""
    import rerun.blueprint as rrb
    return rrb.Blueprint(
        rrb.Horizontal(contents=[
            rrb.Vertical(contents=[
                rrb.Spatial2DView(origin="frame/depth_in"),
                rrb.Spatial2DView(origin="frame/depth"),
                rrb.Spatial2DView(origin="frame/normals"),
                rrb.Spatial2DView(origin="frame/densify_mask"),
                rrb.Spatial2DView(origin="frame/depth_l1"),
            ]),
            rrb.Spatial3DView(origin="world/"),
        ]))


class DataLoggerRR:
    def __init__(self, cfg):
        lc = cfg.logging
        rr.init("splatloam_tpu")
        rr.send_blueprint(_blueprint())
        if lc.rerun_spawn:
            logger.info(rr.spawn())
        elif lc.rerun_serve_grpc:
            logger.info(rr.serve_grpc())
        elif lc.rerun_connect_grpc_url:
            logger.info(rr.connect_grpc(url=lc.rerun_connect_grpc_url))

    def set_timestamp(self, timestamp: float) -> None:
        rr.set_time("time", timestamp=timestamp)

    def log_image(self, topic: str, image) -> None:
        """Image in [0, 1] (the caller normalizes, as in the reference)."""
        img = to_numpy(image)
        rr.log(topic, rr.Image((img * 255).astype(np.uint8)))

    def log_depth_image(self, topic: str, image) -> None:
        rr.log(topic, rr.DepthImage(to_numpy(image)))

    def log_model(self, topic: str, surfels) -> None:
        from ..geometry.se3 import quat_to_rotmat
        from ..model.surfels import compact_arrays
        arrs = compact_arrays(surfels)
        if len(arrs["xyz"]) == 0:
            return
        scales = np.exp(arrs["log_scale"])
        # 3.3 sigma extent + flat third axis (ref rerun_logging.py:75-78)
        half_sizes = np.concatenate(
            [3.3 * scales, np.full((len(scales), 1), 1e-3)], axis=-1)
        quats = arrs["quat"]
        normals = to_numpy(quat_to_rotmat(torch.from_numpy(quats)))[..., :3,
                                                                     -1]
        colors = (normals * 0.5 + 0.5).astype(np.float32)
        rr.log(topic, rr.Ellipsoids3D(
            centers=arrs["xyz"], half_sizes=half_sizes,
            quaternions=rr.Quaternion(
                xyzw=np.roll(quats, -1, axis=-1)),
            colors=colors,
            fill_mode=rr.components.FillMode.Solid))

    def log_transform(self, topic: str, T) -> None:
        T = to_numpy(T)
        rr.log(topic, rr.Transform3D(translation=T[:3, 3],
                                     mat3x3=T[:3, :3], axis_length=1.0))

    def log_pointcloud(self, topic: str, points) -> None:
        rr.log(topic + "/cloud", rr.Points3D(to_numpy(points)))

    def log_scalar(self, topic: str, value: float) -> None:
        rr.log(topic, rr.Scalars(float(value)))
