"""Readings of the traced sub-window's frames (from a sweep's hand-over
to SLAM.process's return; the time between frames, where the benchmark
makes the next sweep, is left out): the device's busy time (the union of
its operations' intervals), its operations by name, and its idle gaps by
what the host was doing (the innermost of the benchmark's frame ranges
and the program's phases open at the gap)."""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

FWD = re.compile(r"raster_fwd_seg_kernel<([^>]*)>")
BWD = re.compile(r"raster_bwd_seg_kernel<([^>]*)>")


def _frames(run) -> list[tuple[int, int]]:
    """The traced frames' spans: the sub-window less the time between
    frames, where the benchmark makes the next sweep."""
    return sorted((a, b) for name, a, b in run.host_ranges
                  if name == "bench.frame")


def _merge(spans) -> list[list[int]]:
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _intervals(run) -> list[list[int]]:
    """The device's busy intervals within the traced frames."""
    frames = _frames(run)
    starts = [a for a, _ in frames]
    out = []
    for _, start, dur in run.device_events:
        end = start + dur
        k = max(bisect.bisect_right(starts, start) - 1, 0)
        while k < len(frames) and frames[k][0] < end:
            a, b = max(start, frames[k][0]), min(end, frames[k][1])
            if b > a:
                out.append((a, b))
            k += 1
    return _merge(out)


def busy_and_window(run) -> tuple[float, float]:
    """(seconds some operation ran on the device, seconds of the traced
    frames), both over the traced sub-window's frames."""
    busy = sum(b - a for a, b in _intervals(run))
    return busy * 1e-9, sum(b - a for a, b in _frames(run)) * 1e-9


def kernel_launches(run, which: str) -> list[int]:
    """Durations (ns) of the K1 ("fwd": the tiled forward) or K2 ("bwd":
    the tiled backward that writes per-slot rows) launches in the
    traced sub-window, told apart from the flat and fused variants of
    the same templates by their template arguments."""
    out = []
    for name, _, dur in run.device_events:
        if which == "fwd":
            m = FWD.search(name)
            # <PPL, MED, DIST, FLAT>: the tiled layout has FLAT false
            if m and m.group(1).replace(" ", "").split(",")[-1] in (
                    "false", "0"):
                out.append(dur)
        else:
            m = BWD.search(name)
            # <PPL, DIST, MED, MODE>: Out::ROWS is 0
            if m:
                mode = m.group(1).replace(" ", "").split(",")[-1]
                if mode.endswith(("0", "ROWS")):
                    out.append(dur)
    return out


def _segments(ranges) -> tuple[list[int], list[str]]:
    """Cut the time line at every range's ends: (segment starts, the
    innermost range open over each segment)."""
    cuts = sorted({t for _, a, b in ranges for t in (a, b)})
    labels = []
    for t in cuts:
        inner = [r for r in ranges if r[1] <= t < r[2]]
        labels.append(max(inner, key=lambda r: r[1])[0] if inner
                      else "between frames")
    return cuts, labels


def breakdown(run) -> dict:
    ops = defaultdict(int)
    for name, _, dur in run.device_events:
        ops[name[:160]] += dur
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    merged = _intervals(run)
    gaps = []
    for lo, hi in _frames(run):
        prev = lo
        for a, b in merged:
            if b <= lo or a >= hi:
                continue
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
    starts, labels = _segments(
        [r for r in run.host_ranges if r[0] != "bench.window"])
    idle = defaultdict(int)
    for a, b in gaps:
        k = bisect.bisect_right(starts, (a + b) // 2) - 1
        idle[labels[k] if k >= 0 else "between frames"] += b - a
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, d * 1e-9] for n, d in device_ops],
            "idle_gaps": [[n, d * 1e-9] for n, d in idle_gaps]}
