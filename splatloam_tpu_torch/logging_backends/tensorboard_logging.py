"""TensorBoard data-logger backend.

The port's copy of splatloam_tpu/logging_backends/tensorboard_logging.py.
The reference's DataLoggerType enum names wandb/tensorboard but registers
only rerun (ref utils/config_utils.py:38-41 vs logging_backends/__init__.py
:6-8); here tensorboard is actually wired (torch ships the writer).
Images log as normalized heatmaps; surfel models as scalar count + size;
transforms as translation scalars.  Tensors are read back to the host
with ``.detach().cpu().numpy()``.
"""
from __future__ import annotations

import numpy as np
from torch.utils.tensorboard import SummaryWriter

from ..logging_utils import get_logger
from . import to_numpy

logger = get_logger("tensorboard")


class DataLoggerTB:
    def __init__(self, cfg):
        out = (cfg.output.folder or "results") + "/tensorboard"
        self.writer = SummaryWriter(log_dir=out)
        self.step = 0
        logger.info(f"tensorboard logs -> {out}")

    def set_timestamp(self, timestamp: float) -> None:
        self.step += 1
        self.writer.add_scalar("time/timestamp", timestamp, self.step)

    def _image01(self, image) -> np.ndarray:
        img = to_numpy(image).astype(np.float32)
        if img.ndim == 3 and img.shape[-1] in (1, 3):
            img = np.moveaxis(img, -1, 0)
        if img.ndim == 2:
            img = img[None]
        lo, hi = np.nanmin(img), np.nanmax(img)
        if hi > lo:
            img = (img - lo) / (hi - lo)
        return np.nan_to_num(img)

    def log_image(self, topic: str, image) -> None:
        self.writer.add_image(topic, self._image01(image), self.step)

    def log_depth_image(self, topic: str, image) -> None:
        self.writer.add_image(topic, self._image01(image), self.step)

    def log_model(self, topic: str, surfels) -> None:
        n = int(surfels.num_active)
        self.writer.add_scalar(f"{topic}/num_surfels", n, self.step)
        self.writer.add_scalar(f"{topic}/size_mb",
                               10 * 4 * n / (1024.0 ** 2), self.step)

    def log_transform(self, topic: str, T) -> None:
        T = to_numpy(T)
        for axis, name in enumerate("xyz"):
            self.writer.add_scalar(f"{topic}/t{name}",
                                   float(T[axis, 3]), self.step)

    def log_pointcloud(self, topic: str, points) -> None:
        self.writer.add_scalar(f"{topic}/num_points",
                               int(to_numpy(points).shape[0]), self.step)

    def log_scalar(self, topic: str, value: float) -> None:
        self.writer.add_scalar(topic, float(value), self.step)
