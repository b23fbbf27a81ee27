"""The port's overflow scatter (K6, ``kernels.scatter_overflow``) and its
tile-grouped scatter (K10, ``kernels.scatter_rows_tps``) against the JAX
package on the CPU, on skewed and adversarial inputs made with numpy.

  * K6 inside the occurrence-plan reduction, against JAX
    ``pallas_raster._scatter_with_plan`` on the same ``ScatterPlan``: a plan
    built from lists where one surfel sits in every tile (a run of more than
    1000 overflow entries of one id), and hand-made plans whose runs of
    equal ids straddle entries 32, 256 and 1024, with n_ov in
    {0, 1, 33, cap}; ids shuffled within the live entries give the same
    sums; K6's gather of each entry's row equals the gathered copy passed
    with identity slots.
  * K10 against JAX ``pallas_raster._scatter_rows`` for tps in
    {1, 2, 8, T}, with tiles whose counts are 0 and K.
  * K4 (``kernels.scatter_rows``, K10's kernel launch at tps 1) against
    JAX ``_scatter_rows`` at tps 1, on those tiles and on lists where one
    surfel sits in every tile, and against numpy over 70,000 tiles (more
    than a CUDA grid's 65,535 rows).

The JAX side runs its Pallas kernels in interpret mode; on CPU tensors the
port's wrappers run their plain versions.  Tolerance 1e-5 * max(1, max|dF|)
throughout: the same sums in another order.
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

# the JAX kernel reads its overflow lists in chunks of 512 entries
OV_CHUNK = pallas_raster._OV_CHUNK


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_raster, "_INTERPRET", True)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.kernels, "
            "splatloam_tpu_torch.ops.rasterizer.cuda_raster; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _assert_sums(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def _jax_plan_dF(rows, plan, n_plus1):
    """JAX ``_scatter_with_plan`` of one view's rows [T*K, 16] under the
    port's plan (occ, ov_slots, ov_ids, n_ov) -> dF [N+1, 16]."""
    jplan = pallas_raster.ScatterPlan(
        *(jnp.asarray(np.asarray(x))[None] for x in plan))
    dFg = jnp.asarray(rows.numpy()).reshape(1, -1, 16)
    return pallas_raster._scatter_with_plan(dFg, jplan, 1, n_plus1)[0]


def _live(plan, k, n_rows, n):
    """The plan with its first ``k`` overflow entries live and the rest
    pads (slot n_rows reads the appended zero row, id n the dummy), as a
    plan holds them past its n_ov: the JAX kernel's last quad may read up
    to 3 entries past n_ov."""
    occ, slots, ids = plan[:3]
    slots, ids = slots.clone(), ids.clone()
    slots[k:], ids[k:] = n_rows, n
    return occ, slots, ids, torch.tensor(k, dtype=torch.int32)


def _hot_lists(rng, n_tiles=1100, k=8, n=300, hot=7):
    """[T, K] lists where surfel ``hot`` sits in every tile and the other
    slots hold distinct random surfels; counts from 1 to K, pads = n."""
    lists = np.full((n_tiles, k), n, np.int32)
    others = np.delete(np.arange(n), hot)
    for t in range(n_tiles):
        c = int(rng.integers(1, k + 1))
        lists[t, 0] = hot
        lists[t, 1:c] = rng.choice(others, c - 1, replace=False)
    return lists


@pytest.mark.parametrize("n_ov", [0, 1, 33, "cap"])
def test_plan_scatter_hot_surfel_vs_pallas(rng, n_ov):
    """One surfel in all 1100 tiles: its 1096 occurrences past the plan's
    4 columns form one run of overflow entries, beside the other surfels'
    short runs; the port's plan equals the JAX package's, and the plan
    reduction (gather-sum + K6) equals JAX's with n_ov set to 0, 1, 33 and
    the whole capacity (pad entries add the zero row into the dummy)."""
    n, cap = 300, 8 * OV_CHUNK
    lists = _hot_lists(rng, n=n)
    plan = binning.build_scatter_plan(torch.tensor(lists), n, m=4,
                                      ov_cap=cap)
    jplan = jbin.build_scatter_plan(jnp.asarray(lists), n, m=4, ov_cap=cap)
    for a, b in zip(plan, jplan):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = plan[2].numpy()[:int(plan[3])]
    assert int(plan[3]) < cap and (ids == 7).sum() == 1100 - 4
    plan = _live(plan, cap if n_ov == "cap" else n_ov, lists.size, n)
    rows = torch.tensor(rng.normal(size=(lists.size, 16)).astype(np.float32))
    dF = cuda_raster._scatter_with_plan(rows, cuda_raster.ScatterPlan(*plan),
                                        n + 1)
    _assert_sums(dF, _jax_plan_dF(rows, plan, n + 1))


def _straddling_plan(rng, n_rows, n=40, cap=3 * OV_CHUNK):
    """A hand-made overflow list of ``cap`` entries sorted by id whose
    runs cross entries 32, 256 and 1024 (and the warp and block edges
    around them), with distinct random slots; the occurrence table is all
    pad, so the plan reduction is K6 alone."""
    cuts = np.array([0, 3, 20, 45, 46, 250, 263, 300, 1000, 1050, 1300, cap])
    ids = np.repeat(rng.permutation(n)[:len(cuts) - 1], np.diff(cuts))
    slots = rng.permutation(n_rows)[:cap]
    occ = np.full((n + 1, 4), n_rows, np.int32)
    return (torch.tensor(occ), torch.tensor(slots.astype(np.int32)),
            torch.tensor(ids.astype(np.int32)))


@pytest.mark.parametrize("n_ov", [0, 1, 33, 300, 1030, "cap"])
def test_overflow_straddling_runs_vs_pallas(rng, n_ov):
    n, n_rows = 40, 2000
    occ, slots, ids, n_ov = _live(
        _straddling_plan(rng, n_rows, n),
        3 * OV_CHUNK if n_ov == "cap" else n_ov, n_rows, n)
    rows = torch.tensor(rng.normal(size=(n_rows, 16)).astype(np.float32))
    ref = _jax_plan_dF(rows, (occ, slots, ids, n_ov), n + 1)
    rows1 = torch.cat([rows, rows.new_zeros((1, 16))])
    _assert_sums(kernels.scatter_overflow(rows1, slots, ids, n_ov, n + 1),
                 ref)
    plan = cuda_raster.ScatterPlan(occ, slots, ids, n_ov)
    _assert_sums(cuda_raster._scatter_with_plan(rows, plan, n + 1), ref)


@pytest.mark.parametrize("n_ov", [33, 1030, "cap"])
def test_overflow_shuffled_ids_same_sums(rng, n_ov):
    """The live entries in a random order (no runs left) sum to the same
    dF as in id order; the gather inside K6 equals the gathered copy
    passed with identity slots (the earlier composition)."""
    n, n_rows = 40, 2000
    _, slots, ids = _straddling_plan(rng, n_rows, n)
    cap = slots.numel()
    k = cap if n_ov == "cap" else n_ov
    n_ov = torch.tensor(k, dtype=torch.int32)
    rows = torch.tensor(rng.normal(size=(n_rows, 16)).astype(np.float32))
    ref = kernels.scatter_overflow(rows, slots, ids, n_ov, n + 1)
    perm = torch.cat([torch.tensor(rng.permutation(k)),
                      torch.arange(k, cap)])
    _assert_sums(kernels.scatter_overflow(rows, slots[perm], ids[perm], n_ov,
                                          n + 1), ref)
    identity = torch.arange(cap, dtype=torch.int32)
    _assert_sums(kernels.scatter_overflow(rows[slots.long()], identity, ids,
                                          n_ov, n + 1), ref)
    assert float(torch.abs(ref).max()) > 0


def _tile_lists(rng, n_tiles=16, k=32, n=60):
    """[T, K] lists of distinct surfels per tile (pads = n), counts from 0
    to K with at least one tile of each extreme."""
    counts = rng.integers(0, k + 1, n_tiles).astype(np.int32)
    counts[[1, 6]] = 0
    counts[[2, n_tiles - 1]] = k
    lists = np.full((n_tiles, k), n, np.int32)
    for t, c in enumerate(counts):
        lists[t, :c] = rng.choice(n, c, replace=False)
    return lists, counts


@pytest.mark.parametrize("tps", [1, 2, 8, 16])
def test_scatter_rows_tps_vs_pallas(rng, tps):
    """K10 against JAX ``_scatter_rows`` at tps 1, 2, 8 and T = 16 (rows
    [:-1]: the JAX kernel's last quad of a tile may add pad rows into the
    dummy row N, which the caller discards)."""
    n = 60
    lists, counts = _tile_lists(rng, n=n)
    dFg = rng.normal(size=(*lists.shape, 16)).astype(np.float32)
    ref = pallas_raster._scatter_rows(jnp.asarray(dFg),
                                      jnp.asarray(lists.reshape(-1)),
                                      jnp.asarray(counts), n + 1, tps)
    dF = kernels.scatter_rows_tps(torch.tensor(dFg), torch.tensor(lists),
                                  torch.tensor(counts), n + 1, tps)
    _assert_sums(dF[:-1], np.asarray(ref)[:-1])
    assert np.abs(np.asarray(ref)[:-1]).max() > 0


@pytest.mark.parametrize("lists_of", ["counts 0 to K", "one surfel in all"])
def test_scatter_rows_vs_pallas(rng, lists_of):
    """K4 against JAX ``_scatter_rows(..., tps=1)`` (rows [:-1], as
    above); the hot surfel's row sums one row of every tile."""
    if lists_of == "counts 0 to K":
        n = 60
        lists, counts = _tile_lists(rng, n=n)
    else:
        n = 300
        lists = _hot_lists(rng, n_tiles=256, n=n)
        counts = (lists != n).sum(axis=1).astype(np.int32)
    dFg = rng.normal(size=(*lists.shape, 16)).astype(np.float32)
    ref = np.asarray(pallas_raster._scatter_rows(
        jnp.asarray(dFg), jnp.asarray(lists.reshape(-1)),
        jnp.asarray(counts), n + 1, 1))
    dF = kernels.scatter_rows(torch.tensor(dFg), torch.tensor(lists),
                              torch.tensor(counts), n + 1)
    _assert_sums(dF[:-1], ref[:-1])
    assert np.abs(ref[:-1]).max() > 0


def test_scatter_rows_tps_needs_a_divisor(rng):
    lists, counts = _tile_lists(rng)
    dFg = torch.zeros((*lists.shape, 16))
    with pytest.raises(ValueError, match="must divide"):
        kernels.scatter_rows_tps(dFg, torch.tensor(lists),
                                 torch.tensor(counts), 61, 3)


def test_scatter_rows_many_tiles(rng):
    """K4 over 70,000 tiles of 4 slots, counts 0 to K, against numpy's
    ``np.add.at`` (JAX's interpret mode walks its grid in Python, too slow
    at this size)."""
    n_tiles, k, n = 70_000, 4, 500
    counts = rng.integers(0, k + 1, n_tiles).astype(np.int32)
    lists = rng.integers(0, n, (n_tiles, k)).astype(np.int32)
    real = np.arange(k)[None, :] < counts[:, None]
    lists[~real] = n
    dFg = rng.normal(size=(n_tiles, k, 16)).astype(np.float32)
    ref = np.zeros((n + 1, 16))
    np.add.at(ref, lists[real], dFg[real])
    dF = kernels.scatter_rows(torch.tensor(dFg), torch.tensor(lists),
                              torch.tensor(counts), n + 1)
    _assert_sums(dF, ref)
