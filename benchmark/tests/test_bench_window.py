"""The window: the first ``window_frames`` frames after set-up, whatever
the program's speed, with ``--seconds`` a guard that cuts a window too
slow to finish and says so in the result line.  On the tiny CPU cell,
under the harness's stepped clock where a guard is read."""
import pytest

import harness
import tiny
from splatloam_tpu_torch.slam import SLAM

DELAY_S = 0.1


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("window"))


def _run(path, monkeypatch, delay: float = 0.0, **kw):
    """tiny.run -> (result, the window's frame indices); with ``delay``
    each frame's SLAM.process sleeps that long first, on the harness's
    clock."""
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)
    monkeypatch.setattr(harness, "Run", Kept)
    if delay:
        process = SLAM.process

        def slow(self, frame):
            harness.time.sleep(delay)
            return process(self, frame)
        monkeypatch.setattr(SLAM, "process", slow)
    result, _ = tiny.run(path, **kw)
    monkeypatch.undo()
    (run,) = runs
    return result, [f["index"] for f in run.frames]


def test_window_holds_exactly_its_frames(checkout, monkeypatch):
    res, idx = _run(checkout, monkeypatch, frames=7)
    assert res["attempted"] == res["window"]["frames"] == len(idx) == 7
    assert res["window"]["window_frames"] == 7
    assert res["window"]["guard_cut"] is False
    # consecutive sweeps, the first after set-up
    assert idx == list(range(idx[0], idx[0] + 7))
    assert res["window"]["last_index"] == idx[-1]
    assert res["correct"] is True


def test_guard_cuts_the_window_and_says_so(checkout, monkeypatch):
    # two ticks of 0.05 s a frame: 0.5 s holds 5 frames of 20
    res, idx = _run(checkout, monkeypatch, frames=20, seconds=0.5,
                    tick=0.05)
    w = res["window"]
    assert w["guard_cut"] is True and w["window_frames"] == 20
    assert w["frames"] == len(idx) == res["attempted"] < 20
    assert w["seconds"] >= 0.5
    # the metrics are read over the frames the window holds
    fps = res["metrics"]["frames_per_s"]["value"]
    assert fps == pytest.approx(len(idx) / w["seconds"])


def test_a_slower_program_gets_the_same_window(checkout, monkeypatch):
    """A host delay in every frame leaves the window's frames as they
    were; under a window that the guard alone closes, as the harness's
    was before ``window_frames``, the same delay drops frames."""
    fast = _run(checkout, monkeypatch, frames=8, tick=0.05)
    slow = _run(checkout, monkeypatch, delay=DELAY_S, frames=8, tick=0.05)
    assert slow[1] == fast[1] and len(fast[1]) == 8
    assert not fast[0]["window"]["guard_cut"]
    assert not slow[0]["window"]["guard_cut"]
    assert slow[0]["metrics"]["frames_per_s"]["value"] < \
        fast[0]["metrics"]["frames_per_s"]["value"]
    # the guard alone: a window of "all the frames in 0.8 s"
    old_fast = _run(checkout, monkeypatch, frames=10**6, seconds=0.8,
                    tick=0.05)
    old_slow = _run(checkout, monkeypatch, delay=DELAY_S, frames=10**6,
                    seconds=0.8, tick=0.05)
    assert len(old_slow[1]) < len(old_fast[1])
    assert old_slow[1] == old_fast[1][:len(old_slow[1])]
