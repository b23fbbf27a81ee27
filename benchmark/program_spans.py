"""The program's own spans and counters (``splatloam_tpu_torch.profiling``)
in the window's frames outside the traced sub-window.

The harness's ``Program`` resets the process's profiler and hands every
sweep to ``Preprocessor``, which starts the profiler's next frame: the
frame id a span or a counter carries is the frame's ``index``.  What the
comparison runs after the window carries no window frame's id.  A
program whose profiler keeps no spans by frame gives None, as does an
untraced run.
"""
from __future__ import annotations


def _profiler(run):
    if not run.traced:
        return None
    from splatloam_tpu_torch import profiling
    prof = profiling.get_profiler()
    if not (hasattr(prof, "spans") and hasattr(prof, "counts")):
        return None
    return prof


def _frames(run) -> set[int]:
    return {f["index"] for f in run.untraced_frames}


def durations_ms(run, name: str) -> list[float] | None:
    """Each ``name`` span's duration (ms), or None."""
    prof = _profiler(run)
    if prof is None:
        return None
    frames = _frames(run)
    return [1e-6 * (s.end_ns - s.start_ns) for s in prof.spans()
            if s.name == name and s.frame in frames]


def mean_ms(run, name: str) -> float | None:
    """The mean duration (ms) of the ``name`` spans, or None if none."""
    d = durations_ms(run, name)
    return sum(d) / len(d) if d else None


def total(run, name: str) -> float | None:
    """The sum of the counter's increments (0 where there are none), or
    None."""
    prof = _profiler(run)
    if prof is None:
        return None
    frames = _frames(run)
    return float(sum(c.value for c in prof.counts()
                     if c.name == name and c.frame in frames))
