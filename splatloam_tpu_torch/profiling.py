"""Tracing & profiling: spans of the program's phases tagged by frame,
counters, and a report table.

The port's counterpart of splatloam_tpu/profiling.py.  ``phase(name)``
opens a span: its duration goes into ``stats[name]`` and the span itself
(name, frame id, parent span, start and end on ``time.perf_counter_ns``)
into a ring of the newest ``RING_SPANS`` spans.  The parent is the
innermost span open when the span opened; the frame id is the one
``next_frame`` last gave (``Preprocessor`` moves it at each sweep: -1
before the first).  ``count`` adds to a counter and keeps the increment,
tagged by frame, in a ring of its own.  A span measures host time and
reads nothing from the device: callers that time device work end the
span with a value read back from the device.

While a ``torch.profiler`` records, each span also opens a
``record_function`` range ``phase.<name>``, so the trace shows the spans
on the device's clock; without one the check costs a call.
"""
from __future__ import annotations

import contextlib
import time
from array import array
from collections import defaultdict
from typing import NamedTuple

import torch

# spans kept: the NCD reconstruction walk (a 512-iteration update in 32
# blocks every 6th frame) records 85 spans on an update frame and 8 on
# the others, 20.8 a frame: the ring holds its newest ~12,600 frames
RING_SPANS = 1 << 18
# counter increments kept: 35 an update there (32 replays), ~11,200 frames
RING_COUNTS = 1 << 16


class PhaseStats:
    __slots__ = ("count", "total", "ema", "last", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.ema = None
        self.last = 0.0
        self.samples: list[float] = []    # every duration, in order

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.last = dt
        self.samples.append(dt)
        self.ema = dt if self.ema is None else 0.1 * dt + 0.9 * self.ema


class Span(NamedTuple):
    id: int          # spans are numbered in the order they open
    name: str
    frame: int
    parent: int      # the enclosing span's id; -1 at the top
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    name: str
    frame: int
    value: float


class _Ring:
    """The newest ``size`` records of a name and fixed numeric fields
    (``typecodes``, one ``array`` each): the oldest is overwritten."""

    def __init__(self, size: int, typecodes: str):
        self.size = size
        self.written = 0
        self.names: list = [None] * size
        self.cols = [array(t, bytes(array(t).itemsize * size))
                     for t in typecodes]

    def put(self, name: str, *fields) -> None:
        i = self.written % self.size
        self.names[i] = name
        for col, v in zip(self.cols, fields):
            col[i] = v
        self.written += 1

    def records(self) -> list[tuple]:
        """(name, *fields) of each kept record, oldest first."""
        lo = max(0, self.written - self.size)
        out = []
        for k in range(lo, self.written):
            i = k % self.size
            out.append((self.names[i], *(c[i] for c in self.cols)))
        return out


class _Phase:
    """One span: ``Profiler.phase``'s context manager."""
    __slots__ = ("prof", "name", "id", "frame", "parent", "start", "range")

    def __init__(self, prof: "Profiler", name: str):
        self.prof = prof
        self.name = name
        self.range = None

    def __enter__(self):
        p = self.prof
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(f"phase.{self.name}")
            self.range.__enter__()
        self.id = p._opened
        p._opened += 1
        self.frame = p.frame
        self.parent = p._open[-1] if p._open else -1
        p._open.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        p = self.prof
        p._open.pop()
        p.stats[self.name].add((end - self.start) * 1e-9)
        p._spans.put(self.name, self.id, self.frame, self.parent,
                     self.start, end)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class Profiler:
    """Spans, per-phase statistics and counters of one host thread."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: dict[str, PhaseStats] = defaultdict(PhaseStats)
        self.counters: dict[str, float] = defaultdict(float)
        self.increments: dict[str, int] = defaultdict(int)
        self.last_count: dict[str, float] = defaultdict(float)
        self.frame = -1
        self._opened = 0                # spans opened: the next one's id
        self._open: list[int] = []      # ids of the open spans, inner last
        self._spans = _Ring(RING_SPANS, "qqqqq")
        self._counts = _Ring(RING_COUNTS, "qd")

    def phase(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return _Phase(self, name)

    def next_frame(self) -> int:
        """Start the next frame: the spans and counts until the next call
        carry its id."""
        self.frame += 1
        return self.frame

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value
        self.increments[name] += 1
        self.last_count[name] = value
        self._counts.put(name, self.frame, value)

    def spans(self) -> list[Span]:
        """The kept spans, in the order they closed."""
        return [Span(i, name, f, parent, a, b)
                for name, i, f, parent, a, b in self._spans.records()]

    def counts(self) -> list[Count]:
        """The kept counter increments, in order."""
        return [Count(*r) for r in self._counts.records()]

    def report(self) -> str:
        lines = [f"{'phase':<22}{'count':>8}{'total_s':>10}{'ema_ms':>10}"
                 f"{'last_ms':>10}"]
        for name in sorted(self.stats):
            s = self.stats[name]
            ema = 0.0 if s.ema is None else s.ema * 1e3
            lines.append(f"{name:<22}{s.count:>8}{s.total:>10.2f}"
                         f"{ema:>10.1f}{s.last * 1e3:>10.1f}")
        if self.counters:
            lines.append(f"{'counter':<22}{'count':>8}{'total':>10}"
                         f"{'mean':>10}{'last':>10}")
        for name in sorted(self.counters):
            n, total = self.increments[name], self.counters[name]
            lines.append(f"{name:<22}{n:>8}{total:>10.0f}"
                         f"{total / max(n, 1):>10.2f}"
                         f"{self.last_count[name]:>10.0f}")
        return "\n".join(lines)


_global_profiler: Profiler | None = None


def get_profiler() -> Profiler:
    global _global_profiler
    if _global_profiler is None:
        _global_profiler = Profiler()
    return _global_profiler


def reset_profiler() -> None:
    """Drop the global profiler: the next get_profiler() starts empty, at
    frame -1."""
    global _global_profiler
    _global_profiler = None
