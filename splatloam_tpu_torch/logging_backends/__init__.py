"""Pluggable data loggers: the protocol, the no-op dummy and the singleton.

The port's copy of splatloam_tpu/logging_backends/__init__.py.  Only the
dummy backend is ported: with ``logging.enable`` false every call is a
no-op; with it true ``get_datalogger`` raises, since the rerun and
tensorboard backends are not ported yet.
"""
from __future__ import annotations

import threading
from typing import Protocol


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
    raise NotImplementedError(
        f"logging.enable with logger_type {kind!r}: the rerun and "
        "tensorboard backends are not ported yet (ROADMAP.md, queue 1 "
        "item 3); set logging.enable to false")
