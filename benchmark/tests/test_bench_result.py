"""The result line, the exits without a card, and the modules a run
loads."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import tiny
from manifest import HERE

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_last_line_keys(tmp_path, trace):
    res, checks = tiny.run(tiny.make(tmp_path), trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["window", "checks"]
    assert list(res) == want
    assert res["correct"] is True, checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert {"frames_per_s", "frame_ms_p90", "setup_s"} <= set(
            res["metrics"])
    json.dumps(res)


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ncd-recon.walk",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _run_py(HERE.parent)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_alone_in_a_folder_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_in_what_a_run_loads():
    """The harness, the reference, the readers and the port, imported as a
    run imports them: no top-level module named jax, jaxlib, flax or
    splatloam_tpu (compared whole; splatloam_tpu_torch is allowed)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, harness, manifest, tracing, faults\n"
        "import reference.judge, reference.raster, reference.range_image\n"
        "import reference.gauss_newton\n"
        "import counts.raster, counts.peaks, traffic.canyon\n"
        "import splatloam_tpu_torch.slam, splatloam_tpu_torch.preprocessing\n"
        "m = manifest.Manifest(manifest.HERE.parent / 'BENCHMARK.json')\n"
        "for x in m.data['end_to_end'] + m.data['per_layer']:\n"
        "    m.reader(x)\n"
        "for p in (manifest.HERE / 'reference' / 'checks').glob('*.py'):\n"
        "    m.check(p.stem)\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({k.split('.')[0] for k in sys.modules}))\n"
        % (str(HERE), str(HERE.parent)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    found, top = p.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "splatloam_tpu_torch" in top and "'splatloam_tpu'" not in top


def test_reference_imports_nothing_of_the_program():
    for f in (HERE / "reference").rglob("*.py"):
        text = f.read_text()
        assert "splatloam_tpu" not in text.replace("splatloam_tpu_torch/",
                                                   ""), f
        assert "import jax" not in text
