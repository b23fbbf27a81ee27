"""The readers of the program's spans and counters on the tiny CPU cell:
numbers from a traced run, None from an untraced one and from a program
that keeps no spans by frame."""
import json
import types

import pytest

import harness
import tiny
from manifest import Manifest
from splatloam_tpu_torch import profiling

NEW = ("optimize_replay_ms", "optimize_drain_ms", "densify_ms",
       "graph_captures")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(result, the Run its readers read, the manifest) of a traced run."""
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)
    # 5-iteration updates, and a sub-window of one update: the window
    # holds updates outside it
    path = tiny.make(tmp_path_factory.mktemp("spans"), iters=4)
    cell = path.parent / "benchmark" / "workloads" / "tiny.cell.json"
    wl = json.loads(cell.read_text())
    wl["trace_updates"] = 1
    cell.write_text(json.dumps(wl))
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "Run", Kept)
    try:
        result, _ = tiny.run(path, frames=12, trace=True)
    finally:
        mp.undo()
    (run,) = runs
    assert any(f["updated"] for f in run.untraced_frames)
    return result, run, Manifest(path, path.parent / "benchmark")


def _readers(manifest):
    return {m["name"]: manifest.reader(m)
            for m in manifest.data["per_layer"] if m["name"] in NEW}


def test_traced_run_reads_the_program_spans(traced):
    result, run, _ = traced
    metrics = result["metrics"]
    assert metrics["densify_ms"]["value"] > 0
    assert metrics["optimize_drain_ms"]["value"] >= 0
    assert metrics["graph_captures"] == {"value": 0.0, "unit": "count"}
    # the CPU runs the optimize blocks uncaptured: nothing replayed
    assert "optimize_replay_ms" not in metrics
    # the program's frame ids are the harness's frame indices
    pre = {s.frame for s in profiling.get_profiler().spans()
           if s.name == "preprocess"}
    assert {f["index"] for f in run.frames} <= pre


def test_untraced_or_spanless_runs_read_none(traced, monkeypatch):
    _, run, manifest = traced
    readers = _readers(manifest)
    assert sorted(readers) == sorted(NEW)
    monkeypatch.setattr(run, "traced", False)
    assert {n: r(run) for n, r in readers.items()} == dict.fromkeys(NEW)
    # a program whose profiler keeps phases only (no spans by frame)
    monkeypatch.setattr(run, "traced", True)
    monkeypatch.setattr(profiling, "get_profiler",
                        lambda: types.SimpleNamespace(stats={},
                                                      counters={}))
    assert {n: r(run) for n, r in readers.items()} == dict.fromkeys(NEW)
