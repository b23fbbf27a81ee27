"""BENCHMARK.json against the benchmark's contract, and its cells,
configurations and metrics found by name."""
import json
import re

import pytest

from manifest import HERE, NAME, UNIT, Manifest
import tiny

CHECKOUT = HERE.parent
BENCHMARK = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per")


def test_top_level_keys():
    assert list(BENCHMARK) == ["command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert BENCHMARK["paths"] == ["benchmark"]
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHMARK[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCHMARK["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_workloads_report_what_they_move():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    for m in BENCHMARK["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    layers = {}
    for m in BENCHMARK["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "kernels" in layers and "device" in layers


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    man = Manifest(CHECKOUT / "BENCHMARK.json")
    for w in BENCHMARK["workloads"]:
        e2e = [m["name"] for m in man.metrics_of(w, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.metrics_of(w, "per_layer")


def test_run_budget():
    r = BENCHMARK["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_found_by_name():
    man = Manifest(CHECKOUT / "BENCHMARK.json")
    for w in BENCHMARK["workloads"]:
        wl = man.workload_file(w)
        assert {"traffic", "setup", "window_frames", "trace_updates",
                "limits"} <= set(wl)
        assert isinstance(wl["window_frames"], int) and wl["window_frames"] > 0
        cf = man.config_file(w)
        assert {"source", "yaml", "reduced", "assumed", "config"} <= set(cf)
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert callable(man.reader(m))
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == {c["name"] for c in BENCHMARK["configs"]}
    files = [c["file"] for c in BENCHMARK["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("benchmark/") for f in files)


@pytest.mark.parametrize("entry", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_is_the_shipped_yaml_but_reduced(entry):
    cf = json.loads((CHECKOUT / entry["file"]).read_text())
    shipped = tiny.merged_yaml(CHECKOUT / cf["yaml"].split()[0])
    run = cf["config"]
    assert sorted(entry["reduced"]) == sorted(cf["reduced"])
    for key in set(shipped) | set(run):
        if key in entry["reduced"]:
            continue
        assert run.get(key) == shipped.get(key), key
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key)


def test_cell_config_and_metric_added_as_data(tmp_path):
    path = tiny.make(tmp_path)
    bench = json.loads(path.read_text())
    bench["per_layer"].append({
        "name": "frames_seen", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "frames_per_s",
        "workloads": ["tiny.cell"]})
    path.write_text(json.dumps(bench))
    (tmp_path / "benchmark/metrics/frames_seen.py").write_text(
        "def read(run):\n    return len(run.frames)\n")
    man = Manifest(path, tmp_path / "benchmark")
    cell = man.cell("tiny.cell")
    assert man.config_file(cell)["config"]["preprocessing"][
        "image_height"] == 16
    assert man.workload_file(cell)["traffic"]["beams"] == 16
    layer = man.metrics_of(cell, "per_layer")
    assert "frames_seen" in [m["name"] for m in layer]

    class Run:
        frames = [1, 2, 3]
    assert man.reader(layer[-1])(Run()) == 3

