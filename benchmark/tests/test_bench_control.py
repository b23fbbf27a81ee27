"""The comparison that decides ``correct`` fails its control (the TF32
reference in the program's place) and each fault that a cell can have,
with the harness's look for a card skipped and the rest of a run driven
on the CPU at a tiny size: the mapping faults on the tiny ncd-recon
cell, the tracking faults on the tiny tracking cell, which brings its
own checks.  The control at a cell's own size runs on the card (``cuda``
marker), and so does ``half_batch``: at the tiny size the optimizer's
few iterations leave the trained half of the view barely apart from the
other."""
import json
import subprocess
import sys

import pytest
import torch

import tiny
from faults import NAMES
from manifest import HERE, Manifest


def test_sound_run_is_correct(tmp_path):
    res, checks = tiny.run(tiny.make(tmp_path))
    assert res["correct"] is True, checks


def test_control_is_not_correct(tmp_path):
    res, checks = tiny.run(tiny.make(tmp_path), control=True)
    assert res["correct"] is False, checks


CARD_ONLY = ("half_batch",)
TRACKING = ("track_frozen", "track_short")
# a frozen mapper or optimizer shows only after some updates: their
# windows as a guard of 3 s alone gave them on the CPU (126-180 frames;
# a frozen update takes a tenth of a second here); the other faults'
# are the tiny cell's own
FAULT_FRAMES = {"map_frozen": 120, "optimize_frozen": 120}


@pytest.mark.parametrize("fault", [f for f in NAMES
                                   if f not in CARD_ONLY + TRACKING])
def test_fault_is_not_correct(tmp_path, fault):
    res, checks = tiny.run(tiny.make(tmp_path), fault=fault,
                           frames=FAULT_FRAMES.get(fault))
    assert res["correct"] is False, checks


# the tiny ncd-recon cell's checks (float.hex) over a window of 11
# frames, seed 5, two threads, as the harness gave them before a cell
# could bring checks of its own, with the mapper's first block of each
# update on the newest keyframe
BEFORE = {"range_mismatch": "0x0.0p+0", "render_mismatch": "0x0.0p+0",
          "map_hole": "0x1.753bd02647c68p-3",
          "map_normal_deg": "0x1.28c1fb52d9762p+4"}


def test_judges_own_checks_alone_and_as_before(tmp_path, monkeypatch):
    """A cell that names only the judge's four checks loads no check of
    its own (so installs no tap) and reads the four as before."""
    def no_check(self, name):
        raise AssertionError(f"check {name} loaded")
    monkeypatch.setattr(Manifest, "check", no_check)
    res, checks = tiny.run(tiny.make(tmp_path), seed=5, frames=11)
    assert res["attempted"] == 11
    assert {c["name"]: c["value"].hex() for c in checks} == BEFORE


def test_a_limit_without_a_check_ends_the_run(tmp_path):
    path = tiny.make(tmp_path)
    cell = path.parent / "benchmark" / "workloads" / "tiny.cell.json"
    wl = json.loads(cell.read_text())
    wl["limits"]["no_such_check"] = 1.0
    cell.write_text(json.dumps(wl))
    with pytest.raises(KeyError, match="no_such_check"):
        tiny.run(path)


@pytest.fixture(scope="module")
def tracking(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tracking"), tracking=True)


def test_tracking_cell_is_correct(tracking):
    res, checks = tiny.run(tracking, **tiny.TRACK_WINDOW)
    assert res["correct"] is True, checks
    assert [c["name"] for c in checks] == [
        "range_mismatch", "render_mismatch", "map_hole", "map_normal_deg",
        "pose_rpe_m", "track_gap_m"]


@pytest.mark.parametrize("how, check, frames", [
    ("control", "render_mismatch", 8),
    ("track_short", "track_gap_m", 16),
    ("track_frozen", "pose_rpe_m", 32)])
def test_tracking_cell_fails_its_checks(tracking, how, check, frames):
    control = how == "control"
    res, checks = tiny.run(tracking, frames=frames, control=control,
                           fault=None if control else how)
    value = {c["name"]: c["value"] for c in checks}[check]
    assert value > tiny.TRACK_LIMITS[check], checks
    assert res["correct"] is False


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
