"""Per-phase wall timers (the port's copy of splatloam_tpu/profiling.py,
reduced to the ``phase`` timer the mapper uses).

A phase measures host time; callers that time device work end the phase
with a value read back from the device, so the enqueue is not all that
is timed.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


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
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: dict[str, PhaseStats] = defaultdict(PhaseStats)

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


_global_profiler: Profiler | None = None


def get_profiler() -> Profiler:
    global _global_profiler
    if _global_profiler is None:
        _global_profiler = Profiler()
    return _global_profiler
