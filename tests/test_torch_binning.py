"""Tile binning of the PyTorch port against the JAX package: integer
outputs (tile lists, counts, the ranksum plan) must be exactly equal.

Both binners get the same packed surfels (packed once by JAX), so the
comparison isolates the binning itself; pack_surfels' own parity is in
test_torch_raster.py.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloam_tpu.geometry import se3 as jse3
from splatloam_tpu.geometry import spherical as jsph
from splatloam_tpu.ops.rasterizer import binning as jbin
from splatloam_tpu.ops.rasterizer import common as jcommon
from splatloam_tpu_torch.ops.rasterizer import binning, common

H, W = 16, 256


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.cuda_raster, "
            "splatloam_tpu_torch.ops.rasterizer.binning; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _packed(rng, n, big_frac=0.05):
    """JAX-packed scene: surfels on a 7 m cylinder plus a floor, a few of
    them large enough to reach the second and third binning tiers."""
    theta = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-1.0, 1.5, n)
    xyz = np.stack([7 * np.cos(theta), 7 * np.sin(theta), z],
                   -1).astype(np.float32)
    xyz[: n // 3, 2] = -1.4
    xyz[: n // 3, 0] = rng.uniform(-5, 5, n // 3)
    xyz[: n // 3, 1] = rng.uniform(-5, 5, n // 3)
    normals = -xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    quat = jse3.quat_from_normal(jnp.asarray(normals))
    scales = rng.uniform(0.05, 0.4, (n, 2)).astype(np.float32)
    big = rng.uniform(size=n) < big_frac
    scales[big] *= 8.0
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    opac[:5] = 0.001            # culled surfels (radius 0)
    K, _, _ = jsph.spherical_intrinsics(jnp.asarray(xyz), H, W)
    packed = jcommon.pack_surfels(jnp.asarray(xyz), jnp.asarray(scales),
                                  quat, jnp.asarray(opac), jnp.eye(4), K)
    port = common.PackedSurfels(*(torch.tensor(np.asarray(a))
                                  for a in packed))
    return packed, port


GEOMETRIES = [(8, 32, 512), (4, 16, 256), (16, 64, 768)]


@pytest.mark.parametrize("tile_h,tile_w,cap", GEOMETRIES)
def test_sorted_tile_lists_equal(rng, tile_h, tile_w, cap):
    jp, tp = _packed(rng, 400)
    jl, jc, _ = jbin.build_tile_lists_sorted(jp, H, W, tile_h, tile_w, cap)
    tl, tc, _ = binning.build_tile_lists_sorted(tp, H, W, tile_h, tile_w,
                                                cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tl.dtype == torch.int32 and tc.dtype == torch.int32


def test_sorted_tile_lists_small_caps_and_one_tier(rng):
    """Capacity truncation, narrow tier-2 windows and the all-tier-3
    coverage oracle (two_tier=False)."""
    jp, tp = _packed(rng, 300, big_frac=0.2)
    for kw in [dict(cap_ty=3, cap_tx=5), dict(two_tier=False)]:
        jl, jc, _ = jbin.build_tile_lists_sorted(jp, H, W, 8, 32, 64, **kw)
        tl, tc, _ = binning.build_tile_lists_sorted(tp, H, W, 8, 32, 64,
                                                    **kw)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("cap", [64, 512])
def test_exact_tile_lists_equal(rng, cap):
    jp, tp = _packed(rng, 300)
    jl, jc, jo = jbin.build_tile_lists(jp, H, W, 8, 32, cap)
    tl, tc, to = binning.build_tile_lists(tp, H, W, 8, 32, cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("group,gps", [(128, 64), (128, 1), (256, 2)])
def test_ranksum_plan_equal(rng, group, gps):
    jp, tp = _packed(rng, 400)
    jl, _, _ = jbin.build_tile_lists_sorted(jp, H, W, 8, 32, 512)
    tl, _, _ = binning.build_tile_lists_sorted(tp, H, W, 8, 32, 512)
    n = 400
    jplan = jbin.build_ranksum_plan(jl, n, group=group, gps=gps)
    tplan = binning.build_ranksum_plan(tl, n, group=group, gps=gps)
    for name, a, b in zip(["pos", "ranks", "w_first", "rank_of_id"],
                          tplan, jplan):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert binning._ranksum_alloc(n + 1, group) == \
        jbin._ranksum_alloc(n + 1, group)


def test_tile_rays_untile_and_pack_features(rng):
    jp, tp = _packed(rng, 200)
    K = jsph.spherical_intrinsics(
        jnp.asarray(rng.normal(size=(100, 3)).astype(np.float32)), H, W)[0]
    jr, jx = jbin.tile_rays(K, H, W, 8, 32)
    tr, tx = binning.tile_rays(torch.tensor(np.asarray(K)), H, W, 8, 32)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    chans = rng.normal(size=(16, 256, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        binning.untile_px(torch.tensor(chans), H, W, 8, 32).numpy(),
        np.asarray(jbin.untile_px(jnp.asarray(chans), H, W, 8, 32)))
    np.testing.assert_array_equal(binning.pack_features(tp).numpy(),
                                  np.asarray(jbin.pack_features(jp)))
