"""A checkout in a temporary folder with one cell added as data files
alone: a configuration, a traffic mix and their BENCHMARK.json entries,
cut to a size the CPU runs in seconds (16x128 range images, 20-iteration
updates, GT poses), with the plain PyTorch versions of the kernels."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent

# limits of the tiny cell, from CPU readings at this size and seconds 3
# (sound runs, seeds 1-6: range_mismatch 0, render_mismatch 0, map_hole
# 0.18-0.27, map_normal_deg 18.0-21.0 in the one sector of 128 columns;
# optimize_frozen, seeds 1-3: map_normal_deg 28.7-30.3)
TINY_LIMITS = {"range_mismatch": 0.01, "render_mismatch": 0.01,
               "map_hole": 0.32, "map_normal_deg": 25.0}


def make(tmp: Path, config: str = "ncd-recon", cell: str = "ncd-recon.walk",
         hw=(16, 128), iters: int = 20) -> Path:
    """-> the new checkout's BENCHMARK.json; the cell is "tiny.cell"."""
    tmp = Path(tmp)
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    c = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    c["config"]["preprocessing"].update(image_height=hw[0],
                                        image_width=hw[1])
    c["config"]["mapping"]["num_iterations"] = iters
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(c))
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    w["traffic"].update(beams=hw[0], columns=hw[1])
    w["setup"]["max_frames"] = 40
    w["limits"] = {k: TINY_LIMITS[k] for k in w["limits"]}
    (tmp / "benchmark/workloads/tiny.cell.json").write_text(json.dumps(w))
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="benchmark/configs/tiny.json"))
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": f"{cell} cut to {hw[0]}x{hw[1]}"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.cell")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp / "BENCHMARK.json"


def run(path: Path, seed: int = 5, seconds: float = 2.0, trace=False,
        control=False, fault=None):
    """One CPU run of the tiny cell -> (result, checks)."""
    import time

    import harness
    from manifest import Manifest
    m = Manifest(path, path.parent / "benchmark")
    return harness.run_cell(m, "tiny.cell", seed, seconds, trace, "cpu",
                            time.perf_counter(), control=control,
                            fault=fault)
