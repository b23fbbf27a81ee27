"""The comparison that decides ``correct`` fails its control (the TF32
reference in the program's place) and each fault that a cell can have,
with the harness's look for a card skipped and the rest of a run driven
on the CPU at a tiny size.  The control at a cell's own size runs on the
card (``cuda`` marker), and so does ``half_batch``: at the tiny size the
optimizer's few iterations leave the trained half of the view barely
apart from the other."""
import json
import subprocess
import sys

import pytest
import torch

import tiny
from faults import NAMES
from manifest import HERE


def test_sound_run_is_correct(tmp_path):
    res, checks = tiny.run(tiny.make(tmp_path))
    assert res["correct"] is True, checks


def test_control_is_not_correct(tmp_path):
    res, checks = tiny.run(tiny.make(tmp_path), control=True)
    assert res["correct"] is False, checks


CARD_ONLY = ("half_batch",)


@pytest.mark.parametrize("fault", [f for f in NAMES if f not in CARD_ONLY])
def test_fault_is_not_correct(tmp_path, fault):
    res, checks = tiny.run(tiny.make(tmp_path), fault=fault, seconds=3.0)
    assert res["correct"] is False, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at a cell's own size "
                    "runs on the card")


BENCHMARK = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


def _run_on_card(cell, seed, seconds, *extra):
    p = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
         *extra], capture_output=True, text=True, timeout=900,
        cwd=HERE.parent)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_the_cells_size(card, cell, seed):
    assert _run_on_card(cell, seed, 10, "--control", "1")["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("fault", CARD_ONLY)
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_fails_at_the_cells_size(card, cell, seed, fault):
    res = _run_on_card(cell, seed, BENCHMARK["run_seconds"], "--fault",
                       fault)
    assert res["correct"] is False, res["checks"]
