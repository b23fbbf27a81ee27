"""Tracing & profiling: per-phase wall timers, counters, an optional
torch.profiler trace, and a report table.

The port's copy of splatloam_tpu/profiling.py.  A phase measures host
time; callers that time device work end the phase with a value read back
from the device, so the enqueue is not all that is timed.  The trace is a
Chrome trace (``trace.json``) written into ``trace_dir`` by
``stop_trace``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

from .logging_utils import get_logger

logger = get_logger("profiling")


class PhaseStats:
    __slots__ = ("count", "total", "ema", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.ema = None
        self.last = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.last = dt
        self.ema = dt if self.ema is None else 0.1 * dt + 0.9 * self.ema


class Profiler:
    """Phase profiler; optionally drives torch.profiler."""

    def __init__(self, trace_dir: str | None = None, enabled: bool = True):
        self.enabled = enabled
        self.stats: dict[str, PhaseStats] = defaultdict(PhaseStats)
        self.counters: dict[str, float] = defaultdict(float)
        self._trace_dir = trace_dir
        self._trace = None

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats[name].add(time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def start_trace(self) -> None:
        if self._trace_dir and self._trace is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=acts)
            self._trace.start()
            logger.info(f"torch profiler trace -> {self._trace_dir}")

    def stop_trace(self) -> None:
        if self._trace is not None:
            self._trace.stop()
            out = Path(self._trace_dir)
            out.mkdir(parents=True, exist_ok=True)
            self._trace.export_chrome_trace(str(out / "trace.json"))
            self._trace = None

    def report(self) -> str:
        lines = [f"{'phase':<22}{'count':>8}{'total_s':>10}{'ema_ms':>10}"
                 f"{'last_ms':>10}"]
        for name in sorted(self.stats):
            s = self.stats[name]
            ema = 0.0 if s.ema is None else s.ema * 1e3
            lines.append(f"{name:<22}{s.count:>8}{s.total:>10.2f}"
                         f"{ema:>10.1f}{s.last * 1e3:>10.1f}")
        for name in sorted(self.counters):
            lines.append(f"{name:<22}{self.counters[name]:>18.0f}")
        return "\n".join(lines)


_global_profiler: Profiler | None = None


def get_profiler() -> Profiler:
    global _global_profiler
    if _global_profiler is None:
        _global_profiler = Profiler()
    return _global_profiler
