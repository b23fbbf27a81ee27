"""The KITTI odometry cell's data files (``configs/kitti-odom.json``,
``workloads/kitti-odom.drive.json``) and its four tracking metrics:
found by name, the shipped YAML kept whole, the six limits, and the
readers on the tiny tracking cell (None untraced, numbers traced)."""
import json

import pytest

import harness
import tiny
from manifest import HERE, Manifest

CHECKOUT = HERE.parent
NEW = ("track_ms", "gn_align_ms", "target_render_ms", "gn_iters")
LIMITS = {"range_mismatch", "render_mismatch", "map_hole", "map_normal_deg",
          "pose_rpe_m", "track_gap_m"}


def _manifest():
    return Manifest(CHECKOUT / "BENCHMARK.json")


def test_manifest_loads_the_config_and_the_cell():
    man = _manifest()
    cell = man.cell("kitti-odom.drive")
    assert (cell["config"], cell["chips"]) == ("kitti-odom", 1)
    entry = man.config_entry("kitti-odom")
    assert entry["reduced"] == ["logging"]
    cf = man.config_file(cell)
    assert cf["yaml"].split()[0] == tiny.TRACKING_YAML
    assert set(cf["assumed"]) == {"sensor", "scene", "data", "submap"}
    cfg = harness.build_config(cf)
    assert cfg.tracking.method.value == "gsaligner"
    assert cfg.mapping.prob_view_last_keyframe is None
    assert cfg.mapping.lmodel_threshold_ngaussians is None
    assert not cfg.logging.enable


def test_config_keeps_every_key_of_the_shipped_yaml():
    cf = _manifest().config_file({"config": "kitti-odom"})
    shipped = tiny.merged_yaml(CHECKOUT / tiny.TRACKING_YAML)
    run = cf["config"]
    assert set(run) == set(shipped) | {"logging"}
    for key, value in shipped.items():
        assert run[key] == value, key
    assert run["logging"] == {"enable": False}


def test_cell_names_exactly_the_six_limits():
    man = _manifest()
    wl = man.workload_file(man.cell("kitti-odom.drive"))
    assert set(wl["limits"]) == LIMITS
    for name in LIMITS - {"range_mismatch", "render_mismatch", "map_hole",
                          "map_normal_deg"}:
        assert callable(man.check(name).compare)
    t = wl["traffic"]
    assert (t["beams"], t["columns"], t["fov_deg"], t["step_m"]) == (
        64, 1024, [-24.8, 2.0], 0.7)


def test_new_metrics_list_the_cell_alone():
    layer = {m["name"]: m for m in _manifest().data["per_layer"]}
    for name in NEW:
        assert layer[name]["workloads"] == ["kitti-odom.drive"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(result, the Run its readers read, the manifest) of a traced run of
    the tiny tracking cell whose sub-window holds one keyframe update, so
    that the window has keyframes and tracked frames outside it."""
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)
    path = tiny.make(tmp_path_factory.mktemp("kitti"), iters=4,
                     tracking=True)
    cell = path.parent / "benchmark" / "workloads" / "tiny.cell.json"
    wl = json.loads(cell.read_text())
    wl["trace_updates"] = 1
    cell.write_text(json.dumps(wl))
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "Run", Kept)
    try:
        result, _ = tiny.run(path, frames=22, trace=True)
    finally:
        mp.undo()
    (run,) = runs
    assert any(f["updated"] for f in run.untraced_frames)
    return result, run, Manifest(path, path.parent / "benchmark")


def test_traced_tracking_run_reads_the_new_metrics(traced):
    result, run, _ = traced
    metrics = result["metrics"]
    for name in NEW:
        assert metrics[name]["value"] > 0, name
    assert metrics["gn_iters"]["unit"] == "iterations"
    # at most the configured iterations a solve
    assert metrics["gn_iters"]["value"] <= 30
    assert metrics["gn_align_ms"]["value"] <= metrics["track_ms"]["value"]


def test_untraced_run_reads_none(traced, monkeypatch):
    _, run, manifest = traced
    readers = {m["name"]: manifest.reader(m)
               for m in manifest.data["per_layer"] if m["name"] in NEW}
    assert sorted(readers) == sorted(NEW)
    monkeypatch.setattr(run, "traced", False)
    assert {n: r(run) for n, r in readers.items()} == dict.fromkeys(NEW)
