"""The sweep generator: deterministic per seed, periodic along the
street, never runs out."""
import json

import numpy as np
import pytest

from manifest import HERE
from traffic.canyon import SweepStream, stream_seed

CELLS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def small(cell, **kw):
    t = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    t = dict(t["traffic"], beams=16, columns=128, **kw)
    return t


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_sweep(cell):
    a = SweepStream(small(cell), 2**31 + 11, "cpu").sweep(7)
    b = SweepStream(small(cell), 2**31 + 11, "cpu").sweep(7)
    assert a.dtype == np.float32 and a.shape[1] == 3 and len(a) > 1000
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cell", CELLS)
def test_seed_changes_the_jitter_not_the_route(cell):
    s1 = SweepStream(small(cell), 3, "cpu")
    s2 = SweepStream(small(cell), 4, "cpu")
    assert not np.array_equal(s1.sweep(2), s2.sweep(2))
    for i in (0, 9, 1000):
        np.testing.assert_array_equal(s1.pose(i), s2.pose(i))


@pytest.mark.parametrize("cell", CELLS)
def test_periodic_along_the_street(cell):
    t = small(cell)
    base = SweepStream(t, 21, "cpu")
    shifted = SweepStream(dict(t, start_m=t.get("start_m", 0.0)
                               + base.period), 21, "cpu")
    np.testing.assert_array_equal(base.sweep(3), shifted.sweep(3))


@pytest.mark.parametrize("cell", CELLS)
def test_never_runs_out(cell):
    s = SweepStream(small(cell), 5, "cpu")
    far = s.sweep(10**6)
    near = s.sweep(1)
    assert abs(len(far) - len(near)) < 0.05 * len(near)
    r = np.linalg.norm(far, axis=1)
    assert r.max() <= s.max_range + 1e-3 and r.min() > 0.5
    assert s.pose(10**6)[0, 3] == pytest.approx(s.start + s.step * 10**6)


def test_stream_seed_takes_large_seeds():
    assert stream_seed(2**31 + 5, 1, 2) != stream_seed(2**31 + 6, 1, 2)
    assert 0 <= stream_seed(2**40, 3) < 2**63
    with pytest.raises(ValueError):
        stream_seed(-1)
