"""Event logging: rich-backed console loggers with a global level switch.

Re-implements ref utils/logging_utils.py:5-37 (rich is available
when installed; falls back to plain logging otherwise).
"""
from __future__ import annotations

import logging

_LOGGERS: dict[str, logging.Logger] = {}
_LEVEL = logging.INFO

try:
    from rich.logging import RichHandler

    def _make_handler():
        return RichHandler(rich_tracebacks=False, show_path=False)
except Exception:  # pragma: no cover - rich is expected to exist
    def _make_handler():
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s "
                              "%(message)s"))
        return handler


def get_logger(name: str = "") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(f"splatloam.{name}" if name else "splatloam")
    logger.setLevel(_LEVEL)
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(_make_handler())
    _LOGGERS[name] = logger
    return logger


def set_log_level(verbose) -> None:
    """verbose: bool or int — True/1 -> DEBUG, False/0 -> INFO."""
    global _LEVEL
    _LEVEL = logging.DEBUG if verbose else logging.INFO
    for logger in _LOGGERS.values():
        logger.setLevel(_LEVEL)
