"""Pluggable data loggers (ref utils/logging_backends/__init__.py:1-29).

The port's copy of splatloam_tpu/logging_backends/__init__.py.  The
protocol mirrors the reference's DataLoggerProtocol (ref
utils/logging_backends/logging_iface.py:5-23).  With ``logging.enable``
false every call goes to the no-op dummy; with it true the logger is the
tensorboard writer (``logger_type`` tensorboard) or rerun (any other
type), and the dummy when that backend cannot be imported (the rerun-sdk
is optional), as in the reference.
"""
from __future__ import annotations

import threading
from typing import Protocol

import numpy as np
import torch

from ..logging_utils import get_logger

logger = get_logger("datalogger")


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DataLoggerProtocol(Protocol):
    def set_timestamp(self, timestamp: float) -> None: ...
    def log_image(self, topic: str, image) -> None: ...
    def log_depth_image(self, topic: str, image) -> None: ...
    def log_model(self, topic: str, surfels) -> None: ...
    def log_transform(self, topic: str, T) -> None: ...
    def log_pointcloud(self, topic: str, points) -> None: ...
    def log_scalar(self, topic: str, value: float) -> None: ...


class DataLoggerDummy:
    def set_timestamp(self, timestamp: float) -> None:
        pass

    def log_image(self, topic: str, image) -> None:
        pass

    def log_depth_image(self, topic: str, image) -> None:
        pass

    def log_model(self, topic: str, surfels) -> None:
        pass

    def log_transform(self, topic: str, T) -> None:
        pass

    def log_pointcloud(self, topic: str, points) -> None:
        pass

    def log_scalar(self, topic: str, value: float) -> None:
        pass


_logger_instance = None
_logger_lock = threading.Lock()


def get_datalogger(cfg) -> DataLoggerProtocol:
    """Lazy singleton (ref utils/logging_backends/__init__.py:16-29)."""
    global _logger_instance
    with _logger_lock:
        if _logger_instance is None:
            _logger_instance = _build(cfg)
    return _logger_instance


def reset_datalogger() -> None:
    global _logger_instance
    with _logger_lock:
        _logger_instance = None


def _build(cfg) -> DataLoggerProtocol:
    if cfg is None or not cfg.logging.enable:
        return DataLoggerDummy()
    kind = getattr(cfg.logging.logger_type, "value",
                   cfg.logging.logger_type)
    if kind == "tensorboard":
        try:
            from .tensorboard_logging import DataLoggerTB
            return DataLoggerTB(cfg)
        except Exception as e:
            logger.warning(f"tensorboard backend unavailable ({e}); "
                           "using dummy logger")
            return DataLoggerDummy()
    try:
        from .rerun_logging import DataLoggerRR
        return DataLoggerRR(cfg)
    except Exception as e:
        logger.debug(f"rerun backend unavailable ({e}); using dummy logger")
        return DataLoggerDummy()
