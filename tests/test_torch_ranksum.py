"""The port's ranksum reduction K3 (``kernels.ranksum_rows``) and a CPU
model of its owner schedule (``_ranksum_owners`` below).

  * K3's plain version, through ``cuda_raster._reduce_rows_with_ranksum``,
    against JAX ``pallas_raster._reduce_rows_with_ranksum`` (its Pallas
    kernel in interpret mode) on rows 0..N-1, with random non-zero rows at
    the padding slots: the port skips the padding id's entries, so its
    rank row, the pad row N of dF and the dummy row of absent ids are 0
    (JAX sums the pad slots into row N, which nothing reads);
  * the owner schedule against ``index_add_`` in float64, on a plan with
    padding, one whose surfel 0 sits in every tile (a segment of T
    entries, longer than a warp's step) and one with every tile full (no
    padding id: its rank is the dummy row).

Tolerances: 1e-5 * max(1, max|dF|) against JAX (float32 sums in another
order), 1e-12 * max|dF| against index_add_ in float64.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloam_tpu.ops.rasterizer import binning as jbin
from splatloam_tpu.ops.rasterizer import pallas_raster
from splatloam_tpu_torch.ops.rasterizer import binning, cuda_raster, kernels

N = 500
N_TILES, K_CAP = 48, 128
# the kernel's block and the longest segment one of its threads walks
BLOCK, SHORT = 256, 16


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_raster, "_INTERPRET", True)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.cuda_raster; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _lists(kind: str, seed: int = 0):
    """[T, K] int32 tile lists: each tile's count of distinct surfel ids,
    then the padding id N.  "pads": random counts; "hot": the same, with
    surfel 0 first in every tile; "full": every tile full."""
    rng = np.random.default_rng(seed)
    counts = (np.full(N_TILES, K_CAP) if kind == "full"
              else rng.integers(0, K_CAP + 1, N_TILES))
    lists = np.full((N_TILES, K_CAP), N, dtype=np.int32)
    for t, c in enumerate(counts):
        lists[t, :c] = rng.choice(N, c, replace=False)
        if kind == "hot" and c:
            lists[t, :c][lists[t, :c] == 0] = lists[t, 0]
            lists[t, 0] = 0
    return lists


def _plan(lists):
    return cuda_raster.RanksumPlan(*binning.build_ranksum_plan(
        torch.tensor(lists), N, group=cuda_raster.RS_GROUP,
        gps=cuda_raster.RS_GPS))


@pytest.mark.parametrize("kind", ["pads", "hot", "full"])
def test_ranksum_vs_pallas(kind):
    """K3's plain version, in the port's reduction, against JAX on rows
    0..N-1; the padding id's rank row, dF's row N and the dummy row are
    0 under the port's contract."""
    lists = _lists(kind)
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(lists.size, 16)).astype(np.float32)
    assert np.abs(rows[(lists == N).reshape(-1)]).min(initial=1.0) > 0
    jplan = pallas_raster.RanksumPlan(*(
        a[None] for a in jbin.build_ranksum_plan(
            jnp.asarray(lists), N, group=pallas_raster._RS_GROUP,
            gps=pallas_raster._RS_GPS)))
    ref = np.asarray(pallas_raster._reduce_rows_with_ranksum(
        jnp.asarray(rows)[None], jplan, N + 1))[0]
    plan = _plan(lists)
    rows_t = torch.tensor(rows)
    dF = cuda_raster._reduce_rows_with_ranksum(rows_t, plan, N + 1)
    np.testing.assert_allclose(dF[:N].numpy(), ref[:N], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert float(dF[N].abs().max()) == 0.0
    r_alloc = binning._ranksum_alloc(N + 1, cuda_raster.RS_GROUP)
    dFc = kernels.ranksum_rows(rows_t, plan.pos, plan.ranks,
                               plan.rank_of_id[N:], r_alloc)
    pad_rank = int(plan.rank_of_id[N])
    assert float(dFc[pad_rank].abs().max()) == 0.0
    assert float(dFc[-1].abs().max()) == 0.0
    if kind == "full":
        assert pad_rank == r_alloc - 1
    else:
        assert np.abs(ref[N]).max() > 0


def _ranksum_owners(rows, pos, ranks, pad_rank, n_rows: int):
    """K3's schedule in plain PyTorch: blocks of BLOCK entries return when
    their first rank is -1 or the pad rank; the entry that starts a
    segment of another rank owns it and sums up to SHORT rows in order;
    a longer segment goes to the owner's warp, whose lane l sums entries
    l, l + 32, ... of it before the warp's butterfly (which adds the lanes
    pairwise at distances 16, 8, 4, 2, 1)."""
    E = ranks.shape[0]
    r = ranks.tolist()
    pad = int(pad_rank[0])
    dFc = rows.new_zeros((n_rows, 16))
    n_long = 0
    for e in range(E):
        if r[e - e % BLOCK] in (-1, pad) or r[e] in (-1, pad):
            continue
        if e > 0 and r[e - 1] == r[e]:
            continue
        n = 1
        while e + n < E and r[e + n] == r[e]:
            n += 1
        seg = rows[pos[e:e + n].long()]
        if n <= SHORT:
            acc = seg[0].clone()
            for k in range(1, n):
                acc = acc + seg[k]
        else:
            n_long += 1
            lanes = seg.new_zeros((32, 16))
            for k in range(n):
                lanes[k % 32] = lanes[k % 32] + seg[k]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes[:off] + lanes[off:2 * off]
            acc = lanes[0]
        dFc[r[e]] = acc
    return dFc, n_long


@pytest.mark.parametrize("kind", ["pads", "hot", "full"])
def test_owner_schedule_vs_index_add(kind):
    """The owner schedule against index_add_ over the real entries in
    float64; "hot" holds a segment of T entries (the warp's path)."""
    lists = _lists(kind, seed=2)
    plan = _plan(lists)
    rows = torch.tensor(np.random.default_rng(3).normal(
        size=(lists.size, 16)))
    r_alloc = binning._ranksum_alloc(N + 1, cuda_raster.RS_GROUP)
    pad_rank = plan.rank_of_id[N:]
    model, n_long = _ranksum_owners(rows, plan.pos, plan.ranks, pad_rank,
                                    r_alloc)
    ref = kernels.ranksum_rows_plain(rows, plan.pos, plan.ranks, pad_rank,
                                     r_alloc)
    assert float(ref.abs().max()) > 0
    np.testing.assert_allclose(model.numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))
    if kind == "hot":
        assert int((lists == 0).sum()) > 32 and n_long > 0
