"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles each mapping step into one device program
(``jax.jit`` around a ``lax.while_loop`` over rebin blocks, each a
``lax.fori_loop`` of Adam iterations; the tracker's Gauss-Newton
``while_loop`` likewise), so the host issues nothing while it runs.  The
port's counterpart is a CUDA graph: the host records a body once and
then replays it with one call.

``CapturedProgram`` owns a body's static buffers and the graph's private
memory pool (``torch.cuda.graph`` gives each graph its own).  Its first
``run`` runs the body uncaptured on a side stream, the warm-up PyTorch
asks for before a capture (handles, workspaces and the kernels' builds
happen there), and returns that run's real result; then it captures the
body.  Every later ``run`` replays the graph.  The body reads its inputs
from the static buffers, which the caller refreshes with ``load``
(``copy_``) or writes itself.  A failed capture raises ``CaptureError``
naming the body and the CUDA error: nothing runs the body uncaptured in
the graph's place.  There is no CPU path: on CPU tensors the callers run
their loops uncaptured.

Launch accounting: the kernels' launches issued during the capture go
into the program's record (``kernels.recording``), and every replay adds
the record to ``kernels.KERNELS[name].launches``.

Tracing: the owner names the program's spans (``span``): the warm-up
and the capture open ``<span>.capture``, each ``graph.replay()`` call
``<span>.replay``; the profiler's counters ``graph.captures`` and
``graph.replays`` count them beside the program's own ``captures`` and
``replays``, and outlive its release.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Callable, Sequence

import torch

from .ops.rasterizer import kernels
from .profiling import get_profiler


class CaptureError(RuntimeError):
    """A body could not be captured into a CUDA graph."""


def _check_device(tensors) -> None:
    bad = sorted({str(t.device) for t in tensors if t.device.type != "cuda"})
    if bad:
        raise ValueError(f"a captured program takes CUDA tensors, not {bad}:"
                         " on the CPU the callers run their loops uncaptured")


def _record(body: Callable):
    """Capture ``body()`` into a new graph -> (graph, what the body
    returned, the bytes the capture reserved for the graph's private
    pool)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        # inside: torch.cuda.graph empties the allocator's cache first
        before = torch.cuda.memory_reserved()
        outputs = body()
    return graph, outputs, torch.cuda.memory_reserved() - before


@contextlib.contextmanager
def _side_stream():
    """Run the enclosed work on a side stream, ordered after the work
    queued before it and before the work queued after it."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        yield
    current.wait_stream(side)


class CapturedProgram:
    """``body()`` (no arguments: it reads ``static``) captured once into a
    CUDA graph and replayed.  ``static`` are the tensors the program owns
    as its inputs (and, where the body writes them back, its state);
    ``outputs`` what the captured body returned, rewritten by each
    replay; ``span`` the prefix of its spans' names (its owner's phase)."""

    def __init__(self, name: str, body: Callable,
                 static: Sequence[torch.Tensor], *, span: str):
        _check_device(static)
        self.name = name
        self.span = span
        self.body = body
        self.static = tuple(static)
        self.graph = None
        self.outputs = None
        self.launches: Counter = Counter()
        self.captures = 0
        self.replays = 0
        # device memory the capture reserved for the graph's private pool
        self.pool_bytes = 0

    @property
    def static_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.static)

    def load(self, *args) -> None:
        """Copy ``args`` into the static buffers, in order (None leaves a
        buffer as it is)."""
        if len(args) != len(self.static):
            raise ValueError(f"{self.name}: {len(args)} inputs for "
                             f"{len(self.static)} static buffers")
        for dst, src in zip(self.static, args):
            if src is not None and src is not dst:
                dst.copy_(src)

    def __call__(self, *args):
        self.load(*args)
        return self.run()

    def run(self):
        """Replay the graph; on the first call, run the body uncaptured
        (its result is returned) and capture it."""
        if self.graph is not None:
            return self.replay()
        with get_profiler().phase(f"{self.span}.capture"):
            with _side_stream():
                out = self.body()
            self.capture()
        return out

    def capture(self) -> None:
        try:
            with kernels.recording() as rec:
                graph, outputs, pool_bytes = _record(self.body)
        except RuntimeError as e:
            raise CaptureError(f"capturing {self.name} failed: {e}") from e
        self.graph, self.outputs, self.launches = graph, outputs, rec
        self.pool_bytes = pool_bytes
        self.captures += 1
        get_profiler().count("graph.captures")

    def replay(self):
        prof = get_profiler()
        with prof.phase(f"{self.span}.replay"):
            self.graph.replay()
        self.replays += 1
        prof.count("graph.replays")
        kernels.add_launches(self.launches)
        return self.outputs

    def stats(self) -> dict:
        return dict(captures=self.captures, replays=self.replays,
                    pool_bytes=self.pool_bytes,
                    static_bytes=self.static_bytes)

    def release(self) -> None:
        """Drop the graph and its outputs: the private pool's memory goes
        back to the allocator's cache."""
        self.graph = None
        self.outputs = None
