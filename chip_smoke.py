"""Chip smoke test of the PyTorch/CUDA port (splatloam_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from splatloam_tpu_torch/csrc, then:

  1. holds each kernel (K1 forward, K2 backward, K3 ranksum reduction,
     K4 scatter-add reduction, K5 backward fused with the scatter-add, K6
     overflow scatter-add, K7/K8/K9 forward, backward and scatter-add of
     the flat slot layout, K10 the scatter-add under scatter_tps 8)
     against its plain PyTorch version on the card, at the mapper's
     full-width shapes (64x1024 image, 4x16 tiles, chunk 256, 768 slots
     per tile, 100k surfels) and K1/K2 also at the small-pool geometry
     (8x32 tiles, chunk 256, 1024 slots), and times kernel, plain version
     and, for the reductions, one torch.index_add_; K1 runs with neither
     and with both of the median and the distortion term, K1 and K7 (the
     same body over the same slots as a flat layout) each also held
     against the plain version in float64, pixels whose median is a
     float32/float64 tie at T = 0.5 and tiles whose exit is a tie at
     T_EPS held apart, and K7 against K1; K2, K5 and K8
     (one slot-parallel body in three write modes) are also timed with
     the distortion term, and K5 on the bucketed layout's two buckets;
     K3 is also timed on a plan whose padding-id entries are masked to
     rank -1 (``[confirm]``, with the plan's segment lengths); K5 is also
     held against K2 + K4, K6 runs under the full-width occurrence plan
     (its uncapped overflow count printed beside the cap) and under a
     truncated ranksum plan, each held against K4; K7 is held against K1
     and K8 + K9 against K2 + K4 under a flat budget that drops nothing,
     and K8 into a NaN-filled rows buffer, then K9, against K8 into a
     zero-filled one (K8 writes every row K9 reads; K9 reads no pad's and
     no unowned chunk's), K10 against K4; the default flat budget's
     drops are printed; every
     reduction of K2's rows (K3 on the tiled and the bucketed plan, K4,
     K10, the occurrence plan + K6, the truncated ranksum plan + K6) is
     run again with the rows past each tile's count, which K2 leaves
     unwritten, set to NaN, and must give the same result; then K6 and
     K10 on adversarial inputs (one surfel owning every overflow entry,
     n_ov 0 and 1, shuffled ids; K10 at tps 1, 2, 8 and T), each against
     its plain version and K4, K4 over 70,000 tiles, K1 on adversarial
     tiles (counts 0 and K, opaque stacks, one full tile among empty
     ones) as above, and K2, K5 (its pool against the float64 rows
     reduced by id) and K8 (over the same slots as a flat layout) on the
     main path's tiles at both geometries and on those adversarial tiles,
     with and without the distortion term, against the plain version in
     float64, the float32 plain version's error printed beside, tiles
     with a float32/float64 branch tie held apart and then moved off the
     tie and held again; the resident warps per SM of the forward's
     (K1, K7) and the backward's (K2, K5, K8) slot-parallel bodies are
     printed for both geometries.  Kernel and index_add_ times
     are device time from a CUDA graph replay (``time_ms``: the host
     launches nothing while it runs), each reduction and its index_add_
     with its own zero fill of dF; the reductions also print their
     kernels' times under torch.profiler and the earlier CUDA-event loop
     beside it; the plain versions, which wait on the host, are timed by
     that loop;
  2. holds ``render`` on the cuda backend against the eager golden
     renderer (values, the median included, and gradients) on a reduced
     scene, the gradients of scatter "fused" and "plan" and of layouts
     "bucketed" and "flat" (values too) against that render and the
     eager renderer, and
     ``render_batch`` over 3 views (tiled under each scatter mode, and
     flat) against three single-view renders;
  3. runs the slice: a synthetic 64x1024 sweep through the device
     preprocessing, a ~100k-surfel pool, and ``Mapper.update_model`` with
     the configs/kitti/kitti.yaml settings on two keyframes (ranksum
     reduction), then one more update each with ``scatter`` "rmw",
     "fused" and "plan" and one with ``views_per_iteration`` 3; it checks
     each kernel's launch count and the rendered depth of the result,
     compares the four reductions on one pool, and times one optimize
     iteration's forward + backward under the tiled and the flat layout
     (one view and 3 views) and under scatter_tps 1 and 8;
  4. runs a sequence, ``[slam]``: 12 sweeps of the same street canyon,
     200,000 points each in the KITTI sensor's vertical field of view,
     1.0 m apart along x, through ``Preprocessor``
     and ``SLAM.process`` with configs/kitti/kitti.yaml as it is
     (gsaligner tracking, keyframes at 5 m or fitness 0.3, ranksum); it
     prints frames/s, ms per frame without a keyframe update, the
     keyframe updates' and target renders' ms, the profiler's report,
     each frame's fitness and the odometry's error against GT, and fails
     if a tracked position is more than 0.15 m off GT, if K1, K2 or K3
     did not launch over the sequence or K1 not in a target render, if
     one ``gauss_newton_align`` synchronizes with the host (run under
     ``torch.cuda.set_sync_debug_mode("error")``), or if ``save_results``
     does not write cfg.yaml, odom.txt, graph.yaml and a PLY per submap
     holding its surfels.

It imports nothing of JAX.  It prints one line per kernel check, the
kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failed check exits non-zero.
"""
from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# fp32 operations per (pixel, composited slot) pair, counted from the
# kernels' arithmetic: the splat geometry (~35) plus compositing (~25) in
# the forward; the geometry once plus the gradient algebra (~80) and the
# 16-row sum over pixels in the backward
FWD_OPS_PER_PAIR = 60
BWD_OPS_PER_PAIR = 131

H, W = 64, 1024
N_SURFELS = 100_000
SEED = 0
# phase 4: a 10 Hz sensor at 36 km/h, and the JAX odometry test's gate
# (tests/test_e2e_slam.py)
SEQ_SWEEPS, SEQ_POINTS, SEQ_STEP_M = 12, 200_000, 1.0
TRACK_GATE_M = 0.15
# vertical field of view of the KITTI sensor (Velodyne HDL-64E data
# sheet: +2.0 to -24.9 degrees), in degrees
SENSOR_FOV_DEG = (-24.9, 2.0)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def device_events(prof):
    """The device-side rows of a profile (kernels, copies), without the
    operators that launched them, which carry the same device time
    again."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured into one
    CUDA graph, one replay timed between two CUDA events, over reps.  The
    host launches nothing during the replay, so its pace does not enter;
    the device's own gaps between kernels do, and every kernel fn
    launches counts, the zero fill of its output included.  fn must not
    wait on the host (the plain versions do: ``event_ms`` times them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_ms(fn, reps: int = 20) -> str:
    """fn's kernels and their device time per call under torch.profiler,
    as text: the split that ``time_ms`` cannot give.  The profiler drops
    some device records of long kernels later in a run (seen on the H100
    once the mapper had run), so a kernel whose count is not a multiple
    of reps is marked, and these numbers are never used as times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted(device_events(prof),
                    key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in events) / 1e3 / reps
    parts = ", ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3 / reps:.4f}"
        + (f" (records lost: {e.count} for {reps} calls)"
           if e.count % reps else "")
        for e in events)
    return f"{total:.4f} ms ({parts})"


def event_ms(fn, reps: int = 10) -> float:
    """CUDA events around ``reps`` calls issued from Python, over reps:
    the earlier yardstick.  For a kernel of a few microseconds the host's
    launch pace sets this number; it times the plain versions, which wait
    on the host themselves."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def yardstick(name, kernel_fn, library_fn) -> tuple[float, float]:
    """A reduction's wrapper and its index_add_, each with its own zero
    fill of dF, under the three timers.  Returns their ``time_ms``."""
    ms, lib_ms = time_ms(kernel_fn), time_ms(library_fn)
    print(f"[yardstick] {name}: graph replay kernel {ms:.4f} ms, index_add_ "
          f"{lib_ms:.4f} ms; torch.profiler kernel {profile_ms(kernel_fn)}, "
          f"index_add_ {profile_ms(library_fn)}; event loop kernel "
          f"{event_ms(kernel_fn):.4f} ms, index_add_ "
          f"{event_ms(library_fn):.4f} ms", flush=True)
    return ms, lib_ms


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def make_scene(rng, n: int, h: int, w: int, dev):
    """Seeded street-like scene: surfels on walls at 6-50 m plus a ground
    plane, facing the sensor (bench.py's scene)."""
    from splatloam_tpu_torch.geometry import se3, spherical
    theta = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-2.0, 4.0, n)
    r = rng.uniform(6.0, 50.0, n)
    xyz = np.stack([r * np.cos(theta), r * np.sin(theta), z],
                   -1).astype(np.float32)
    k = n // 3
    xyz[:k] = np.stack([rng.uniform(-40, 40, k), rng.uniform(-40, 40, k),
                        np.full(k, -1.7)], -1)
    xyz_t = torch.tensor(xyz, device=dev)
    normals = -xyz_t / torch.linalg.norm(xyz_t, dim=-1, keepdim=True)
    quat = se3.quat_from_normal(normals)
    scales = torch.tensor(rng.uniform(0.05, 0.3, (n, 2)).astype(np.float32),
                          device=dev)
    opac = torch.tensor(rng.uniform(0.3, 0.95, n).astype(np.float32),
                        device=dev)
    K, _, _ = spherical.spherical_intrinsics(xyz_t, h, w)
    return xyz_t, scales, quat, opac, torch.eye(4, device=dev), K


def report(name, err, tol, ms, plain_ms, library_ms=None):
    lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
    print(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{lib}", flush=True)
    if not err <= tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")


def check_kernels(dev, rng) -> dict:
    """Phase 1: each kernel against its plain version at the main path's
    shapes; returns the per-kernel numbers of the JSON line."""
    from splatloam_tpu_torch.ops.rasterizer import binning, common, kernels
    from splatloam_tpu_torch.ops.rasterizer.api import RenderParams
    from splatloam_tpu_torch.ops.rasterizer import cuda_raster
    from splatloam_tpu_torch.ops.rasterizer.cuda_raster import (
        RS_GPS, RS_GROUP, prepare_tiles)

    results = {}
    geos = [("main", N_SURFELS, dict(tile_h=4, tile_w=16, chunk=256,
                                     tile_list_capacity=768)),
            ("small-pool", N_SURFELS // 5, dict(tile_h=8, tile_w=32, chunk=256,
                                        tile_list_capacity=1024))]
    for label, n, geo in geos:
        scene = make_scene(rng, n, H, W, dev)
        params = RenderParams(height=H, width=W, backend="cuda",
                              scatter="ranksum", with_median=False,
                              with_dist=False, **geo)
        tiles = prepare_tiles(*scene, params, margin_px=1.5)
        F = binning.pack_features(common.pack_surfels(*scene)).contiguous()
        args = (F, tiles.lists, tiles.counts, tiles.rays_t, tiles.pix_t)

        # the mapper's flags (no median, no distortion term) first, then
        # the render API's (both); K2 runs on the first forward, and is
        # timed with the distortion term on the second
        out, tb, err1, ms1, pms1 = check_fwd(
            f"K1_fwd[{label}]", kernels, args, params.chunk, False, False,
            timed=True)
        fwd_dist = check_fwd(f"K1_fwd[{label}]", kernels, args, params.chunk,
                             True, True, timed=True)[:2]

        g = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32),
                         device=dev)
        bkw = dict(chunk=params.chunk, width=W, with_dist=False)
        bargs = (*args, tb, out, g)
        dFg = kernels.raster_bwd(*bargs, **bkw)
        dFg_p = kernels.raster_bwd_plain(*bargs, **bkw)
        torch.cuda.synchronize()
        # per-slot sums over the tile's pixels in another order, and T_i as
        # a running product vs exp of a log-space prefix sum; galpha divides
        # a suffix sum by max(1 - alpha, 1e-3), which magnifies those
        # rounding differences up to 1000-fold: the repo's gradient
        # tolerance, 2e-3 of the largest row entry.  K2 leaves the rows
        # past each tile's count unwritten: the real slots are compared
        real = (torch.arange(tiles.lists.shape[1], device=dev)[None, :]
                < tiles.counts[:, None])
        err2 = float((dFg - dFg_p)[real].abs().max())
        tol2 = 2e-3 * float(dFg_p.abs().max())
        for dist in (False, True):
            hold_bwd_to_float64(f"[kernel] {label}", kernels, common, args,
                                g, params.chunk, dist)
        ms2 = time_ms(lambda: kernels.raster_bwd(*bargs, **bkw))
        pms2 = event_ms(lambda: kernels.raster_bwd_plain(*bargs, **bkw), 3)
        report(f"K2_bwd[{label}]", err2, tol2, ms2, pms2)
        p_tile = tiles.rays_t.shape[1]
        names = ("K2_bwd", "K5_bwd_fused", "K8_bwd_flat")
        warps = [[kernels.resident_warps(k, p_tile, params.chunk, d)
                  for k in names] for d in (False, True)]
        print(f"[occupancy] {label} ({p_tile} px, chunk {params.chunk}): "
              f"resident warps per SM of the backward's slot-parallel body, "
              f"K2/K5/K8 {'/'.join(map(str, warps[0]))}; with_dist "
              f"{'/'.join(map(str, warps[1]))}", flush=True)
        warps = [kernels.resident_warps(k, p_tile, params.chunk, f, f)
                 for f in (False, True) for k in ("K1_fwd", "K7_fwd_flat")]
        print(f"[occupancy] {label} ({p_tile} px, chunk {params.chunk}): "
              f"resident warps per SM of the forward's slot-parallel body, "
              f"K1/K7 {warps[0]}/{warps[1]}; with the median and the "
              f"distortion term {warps[2]}/{warps[3]}", flush=True)
        if label != "main":
            continue

        # work this run's data needs: the slots each tile composited
        n_live = ((tb > common.T_EPS).any(dim=1)).sum(dim=1)
        slots = torch.minimum(tiles.counts.long(), n_live * params.chunk)
        pairs = float(slots.sum()) * tiles.rays_t.shape[1]
        b1, by1 = bound(nbytes(*args, out, tb), pairs * FWD_OPS_PER_PAIR)
        # K2 writes the rows of the real slots
        b2, by2 = bound(nbytes(*args, tb, out, g) + int(real.sum()) * 64,
                        pairs * BWD_OPS_PER_PAIR)
        results["K1_fwd"] = dict(max_abs_err=err1, ms=ms1, plain_ms=pms1,
                                 bound_ms=b1, bound_by=by1, library_ms=None)
        results["K2_bwd"] = dict(max_abs_err=err2, ms=ms2, plain_ms=pms2,
                                 bound_ms=b2, bound_by=by2, library_ms=None)

        plan = tiles.plan
        rows = dFg.reshape(-1, 16)
        n_rows = F.shape[0]
        r_alloc = binning._ranksum_alloc(n_rows, RS_GROUP)
        k3_args = (rows, plan.pos, plan.ranks, plan.rank_of_id[n_rows - 1:],
                   r_alloc)
        dFc = kernels.ranksum_rows(*k3_args)
        dFc_p = kernels.ranksum_rows_plain(*k3_args)
        dF4 = kernels.scatter_rows(dFg, tiles.lists, tiles.counts, n_rows)
        dF4_p = kernels.scatter_rows_plain(dFg, tiles.lists, tiles.counts,
                                           n_rows)
        torch.cuda.synchronize()
        # float sums of the same rows in another order
        tol34 = 1e-5 * max(1.0, float(dFc_p.abs().max()))
        err3 = float((dFc - dFc_p).abs().max())
        err4 = float((dF4 - dF4_p).abs().max())
        # the two reductions agree with each other (pad ids aside)
        err34 = float((dFc[plan.rank_of_id.long()][:-1] - dF4[:-1])
                      .abs().max())
        if not err34 <= tol34:
            fail(f"K3 and K4 disagree: {err34} > {tol34}")
        # the padding id's rank row and the dummy row of absent ids
        zero_rows = float(dFc[plan.rank_of_id[-1].long()].abs().max()
                          + dFc[-1].abs().max())
        if zero_rows != 0.0:
            fail(f"K3 wrote the pad rank's or the dummy row: {zero_rows}")

        ms3 = time_ms(lambda: kernels.ranksum_rows(*k3_args))
        pms3 = event_ms(lambda: kernels.ranksum_rows_plain(*k3_args))
        real3 = (plan.ranks >= 0) & (plan.ranks != plan.rank_of_id[-1])
        rank_real = plan.ranks[real3].long()
        rows_real3 = rows[plan.pos[real3].long()]
        lib3 = time_ms(lambda: rows.new_zeros((r_alloc, 16)).index_add_(
            0, rank_real, rows_real3))
        report("K3_ranksum[main]", err3, tol34, ms3, pms3, lib3)
        confirm_k3_cause(kernels, rows, plan, r_alloc, n_rows)
        E = plan.pos.numel()
        n_real3 = int(real3.sum())
        # the real entries' rows and plan entries read once, the whole
        # accumulator (zero-filled) written once; the earlier bound read
        # every entry's row, the pad segment's included
        b3, by3 = bound(n_real3 * (64 + 4 + 4) + r_alloc * 64, n_real3 * 16)
        b3_all = bound(nbytes(rows, plan.pos, plan.ranks) + r_alloc * 64,
                       E * 16)[0]
        print(f"[kernel] K3 bound: {b3:.4f} ms ({by3}) over the {n_real3} "
              f"real entries; {b3_all:.4f} ms over every row of rows and "
              f"all {E} entries (the earlier bound)", flush=True)
        results["K3_ranksum"] = dict(max_abs_err=err3, ms=ms3,
                                     plain_ms=pms3, bound_ms=b3,
                                     bound_by=by3, library_ms=lib3)

        pms4 = event_ms(lambda: kernels.scatter_rows_plain(
            dFg, tiles.lists, tiles.counts, n_rows))
        ids_real = tiles.lists[real].long()
        rows_real = dFg[real]
        ms4, lib4 = yardstick(
            "K4", lambda: kernels.scatter_rows(dFg, tiles.lists,
                                               tiles.counts, n_rows),
            lambda: dFg.new_zeros((n_rows, 16)).index_add_(0, ids_real,
                                                           rows_real))
        report("K4_scatter_rows[main]", err4, tol34, ms4, pms4, lib4)
        n_real = int(real.sum())
        b4, by4 = bound(n_real * (64 + 4) + nbytes(tiles.counts)
                        + n_rows * 64, n_real * 16)
        results["K4_scatter_rows"] = dict(max_abs_err=err4, ms=ms4,
                                          plain_ms=pms4, bound_ms=b4,
                                          bound_by=by4, library_ms=lib4)
        print(f"[kernel] main-path shapes: tiles {tiles.lists.shape[0]} x "
              f"{tiles.rays_t.shape[1]} px, K {tiles.lists.shape[1]}, "
              f"composited pairs {pairs:.0f}, ranksum entries {E}, "
              f"real slots {n_real}", flush=True)
        results.update(check_fused_and_overflow(
            dev, kernels, binning, cuda_raster, tiles, bargs, bkw, dFg, dF4,
            n_rows, float(slots.sum()), pairs, RS_GROUP * RS_GPS))
        results.update(check_flat_and_tps(
            kernels, cuda_raster, scene, params, tiles, F, (out, tb), g, dFg,
            dF4, pairs, results["K4_scatter_rows"]))
        time_bwd_with_dist(kernels, params, tiles, F, fwd_dist, g, n_rows)
        check_rows_past_count(kernels, binning, cuda_raster, tiles, dFg,
                              n_rows, RS_GROUP * RS_GPS)
        check_bucketed(dev, kernels, binning, cuda_raster, scene, params, F,
                       n_rows)
        check_scatter_adversarial(dev, kernels, cuda_raster, tiles, n_rows)
        check_tiles_adversarial(dev, kernels, binning, common, scene, tiles,
                                params.chunk)
    return results


def confirm_k3_cause(kernels, rows, plan, r_alloc, n_rows,
                     where: str = "phase 1's main-path plan") -> None:
    """K3 on a ranksum plan and on a copy whose padding-id entries carry
    rank -1 (entries every K3 body skips), timed in turns, and the lengths
    of the plan's real rank segments (entries per surfel: the walks K3's
    owners make)."""
    pad_rank = plan.rank_of_id[n_rows - 1:]
    ranks = plan.ranks
    is_pad = ranks == pad_rank
    masked = torch.where(is_pad, -1, ranks)
    real = ranks[(ranks >= 0) & ~is_pad]
    lens = torch.unique_consecutive(real, return_counts=True)[1]

    def k3(r):
        return lambda: kernels.ranksum_rows(rows, plan.pos, r, pad_rank,
                                            r_alloc)

    t = [time_ms(k3(ranks)), time_ms(k3(masked))]
    t += [time_ms(k3(masked)), time_ms(k3(ranks))]
    edges = [1, 2, 3, 5, 9, 17, 33, 65, 1 << 30]
    hist = ", ".join(
        f"{lo}{'-' + str(hi - 1) if hi < edges[-1] else '+'}: "
        f"{int(((lens >= lo) & (lens < hi)).sum())}"
        for lo, hi in zip(edges, edges[1:]))
    lf = lens.double()
    print(f"[confirm] K3 on {where}, in turns: real plan {t[0]:.4f}/"
          f"{t[3]:.4f} ms, pad entries masked to -1 {t[1]:.4f}/{t[2]:.4f} "
          f"ms (real/masked {(t[0] + t[3]) / (t[1] + t[2]):.2f}x); pad entries "
          f"{int(is_pad.sum())} of {ranks.numel()}, real entries "
          f"{real.numel()} in {lens.numel()} segments: length mean "
          f"{float(lf.mean()):.3f}, p99 {float(torch.quantile(lf, 0.99)):.0f},"
          f" max {int(lens.max())}; histogram {hist}", flush=True)


def median_ties(kernels, fwd_args, tb, chunk: int):
    """[T, P] bool: pixels whose median depth is a tie between float
    precisions, so that two correct float32 codes may pick different
    slots: a live (pixel, slot) pair whose T_i or T_i (1 - alpha_i), in
    float64 from the chunk-start T, lies within 1e-5 of 0.5, or whose
    screen-filter/ellipse choice (it picks the pair's depth m) differs
    between float32 and float64 where T crosses 0.5."""
    F, lists, counts, rays, pix = fwd_args
    n_live = kernels._live_chunks(counts, tb, chunk)
    tie = torch.zeros(rays.shape[:2], dtype=torch.bool, device=rays.device)
    for i in range(int(n_live.max()) if n_live.numel() else 0):
        Fc = F[lists[:, i * chunk:(i + 1) * chunk].long()]
        g32 = kernels._splat_geometry(Fc, rays, pix, W)
        g64 = kernels._splat_geometry(Fc.double(), rays.double(),
                                      pix.double(), W)
        a = g64["alpha"]
        Ti = tb[:, :, i:i + 1].double() * torch.exp(
            kernels._excl_cumsum(torch.log1p(-a)))
        after = Ti * (1.0 - a)
        near = ((Ti - 0.5).abs() < 1e-5) | ((after - 0.5).abs() < 1e-5)
        flip = (Ti > 0.5) & (after <= 0.5) & (g32["use2"] != g64["use2"])
        tie |= ((near | flip) & (i < n_live)[:, None, None]).any(dim=-1)
    return tie


def tiled_tbound(tbf, starts, counts, chunk: int, n_chunks: int):
    """K7's flat tbound [T*K/chunk, P] over ``flat_of_tiles``' layout back
    to K1's [T, P, K/chunk] (0 for the chunks past a tile's count)."""
    n_tiles = counts.shape[0]
    ci = torch.arange(n_chunks, device=tbf.device)
    owned = ci[None, :] < ((counts.long() + chunk - 1) // chunk)[:, None]
    idx = starts[0, :-1].long()[:, None] // chunk + ci[None, :]
    tb = tbf.new_zeros((n_tiles, n_chunks, tbf.shape[1]))
    tb[owned] = tbf[idx[owned]]
    return tb.transpose(1, 2)


def exit_ties(kernels, counts, out64, tb64, chunk: int):
    """[T] bool: tiles whose exit may come at another chunk in float32 than
    in float64: at a chunk boundary the tile decided on (after its first
    chunk, before its count), the largest T over its pixels, in float64,
    lies within 1e-5 relative of T_EPS."""
    from splatloam_tpu_torch.ops.rasterizer.common import T_EPS

    def near(m):
        return (m - T_EPS).abs() <= 1e-5 * T_EPS

    n_act = kernels._n_active_chunks(counts, chunk)
    n_live = kernels._live_chunks(counts, tb64, chunk)
    i = torch.arange(tb64.shape[2], device=tb64.device)[None, :]
    inside = near(tb64.amax(dim=1)) & (i >= 1) & (i < n_live[:, None])
    # the boundary where the float64 tile stopped short of its count
    stopped = near(out64[..., 7].amax(dim=1)) & (n_live < n_act)
    return inside.any(dim=1) | stopped


def hold_fwd_to_float64(name, kernels, fwd_args, kw, out, tb, out_p, tb_p,
                        tag: str):
    """K1 (``out``, ``tb``: its result on ``fwd_args``) and K7 over the same
    slots as a flat layout (``flat_of_tiles``, ``tiled_tbound``), each
    against the plain version in float64 on the card, outputs and tbound,
    at 1e-5 * max(1, max|out64|) (K1 and K7 multiply segment products, the
    plain version sums logs: fp32 sums of up to K terms); the float32
    plain version's error (``out_p``, ``tb_p``) is printed beside.  The
    median of pixels in ``median_ties`` (from the float64 tbound) is held
    apart, and so are the tiles in ``exit_ties`` (all their outputs), and
    both counts are printed.  K7 against K1 is a layout check: one body
    over the same segments, pads not composited, so 0 is expected; it
    fails above the same tolerance.  Returns the median ties [T, P]."""
    F, lists, counts, rays, pix = fwd_args
    chunk = kw["chunk"]
    ids, starts = flat_of_tiles(lists, counts, tb, chunk, F.shape[0] - 1)[:2]
    out7, tbf = kernels.raster_fwd_flat(F, ids, starts, rays, pix, **kw)
    tb7 = tiled_tbound(tbf, starts, counts, chunk, tb.shape[2])
    out64, tb64 = kernels.raster_fwd_plain(
        *(a.double() if a.is_floating_point() else a for a in fwd_args),
        **kw)
    torch.cuda.synchronize()
    tie = (median_ties(kernels, fwd_args, tb64, chunk) if kw["with_median"]
           else torch.zeros(out.shape[:2], dtype=torch.bool,
                            device=out.device))
    xtie = exit_ties(kernels, counts, out64, tb64, chunk)
    med = torch.zeros(8, dtype=torch.bool, device=out.device)
    med[5] = True
    keep = ~xtie[:, None, None]

    def err(o, t):
        d = torch.where(med & tie[..., None], 0.0, (o.double() - out64).abs())
        dt = (t.double() - tb64).abs()
        return max(float(torch.where(keep, d, 0.0).max()),
                   float(torch.where(keep, dt, 0.0).max()))

    tol = 1e-5 * max(1.0, float(out64.abs().max()))
    e1, e7, e32 = err(out, tb), err(out7, tb7), err(out_p, tb_p)
    e71 = max(float((out7 - out).abs().max()), float((tb7 - tb).abs().max()))
    e1x = float((out.double() - out64)[xtie].abs().max()) \
        if bool(xtie.any()) else 0.0
    flags = f"median {int(kw['with_median'])}, dist {int(kw['with_dist'])}"
    crossed = int((out64[..., 5] > 0).sum())
    print(f"[{tag}] {name} ({flags}) vs the float64 plain version: K1 "
          f"{e1:.3e}, K7 {e7:.3e}, float32 plain {e32:.3e} (tol {tol:.3e}); "
          f"held apart: median ties {int(tie.sum())} of {crossed} pixels "
          f"with a median, exit ties {int(xtie.sum())} of {xtie.numel()} "
          f"tiles (K1 {e1x:.3e} there); K7 vs K1 {e71:.3e}", flush=True)
    for what, e in (("K1", e1), ("K7", e7)):
        if not e <= tol:
            fail(f"{name} ({flags}): {what} disagrees with the float64 plain "
                 f"version: {e} > {tol}")
    if not e71 <= tol:
        fail(f"{name} ({flags}): K7 disagrees with K1: {e71} > {tol}")
    return tie


def check_fwd(name, kernels, fwd_args, chunk: int, with_median: bool,
              with_dist: bool, timed: bool = False, tag: str = "kernel"):
    """K1 against its plain version, outputs and tbound, at
    1e-5 * max(1, max|out|): products of segment products in the kernel
    and log-space prefix sums in the plain version round differently
    (fp32 sums of up to K terms); the median of pixels in ``median_ties``
    is held apart.  Then K1 and K7 against the float64 plain version and
    K7 against K1 (``hold_fwd_to_float64``).  With ``timed``, also times
    K1 and its plain version and returns (out, tbound, error, ms, plain
    ms)."""
    kw = dict(chunk=chunk, width=W, with_median=with_median,
              with_dist=with_dist)
    out, tb = kernels.raster_fwd(*fwd_args, **kw)
    out_p, tb_p = kernels.raster_fwd_plain(*fwd_args, **kw)
    tie = hold_fwd_to_float64(name, kernels, fwd_args, kw, out, tb, out_p,
                              tb_p, tag)
    d = (out - out_p).abs()
    d[..., 5] = torch.where(tie, 0.0, d[..., 5])
    e_p = max(float(d.max()), float((tb - tb_p).abs().max()))
    tol = 1e-5 * max(1.0, float(out_p.abs().max()))
    flags = f"median {int(with_median)}, dist {int(with_dist)}"
    if not timed:
        print(f"[{tag}] {name} ({flags}) vs its plain version: max_abs_err "
              f"{e_p:.3e} (tol {tol:.3e})", flush=True)
        if not e_p <= tol:
            fail(f"{name} ({flags}) disagrees with its plain version: "
                 f"{e_p} > {tol}")
        return None
    ms = time_ms(lambda: kernels.raster_fwd(*fwd_args, **kw))
    pms = event_ms(lambda: kernels.raster_fwd_plain(*fwd_args, **kw), 3)
    report(f"{name} ({flags})", e_p, tol, ms, pms)
    F, lists, counts, rays, pix = fwd_args
    ids, starts = flat_of_tiles(lists, counts, tb, chunk, F.shape[0] - 1)[:2]
    ms7 = time_ms(lambda: kernels.raster_fwd_flat(F, ids, starts, rays, pix,
                                                  **kw))
    print(f"[kernel] K7 over the same slots as a flat layout ({flags}): "
          f"{ms7:.4f} ms, K1 {ms:.4f} ms", flush=True)
    return out, tb, e_p, ms, pms


def check_flat_and_tps(kernels, cuda_raster, scene, params, tiles, F, fwd, g,
                       dFg, dF4, pairs, k4) -> dict:
    """Phase 1, K7-K10 at the main path's shapes, on check_kernels' scene,
    K1 output ``fwd``, cotangents ``g``, K2 rows ``dFg`` and K4 result
    ``dF4``: K7, K8 and K9 over the flat layout under a budget that drops
    nothing (T*K, so unused budget chunks trail the last tile), each
    against its plain version, K7 against K1 and K8 + K9 against K2 + K4;
    K10 at 8 tiles per block against K4.  Prints the default flat
    budget's drops at this width."""
    results = {}
    out1 = fwd[0]
    n_tiles, k_cap = tiles.lists.shape
    p_tile = tiles.rays_t.shape[1]
    chunk = params.chunk
    n_rows = F.shape[0]
    # sums of the same rows in another order (atomics: run-dependent)
    tol_sum = 1e-5 * max(1.0, float(dF4.abs().max()))

    n_real = int(tiles.counts.sum())
    padded = int(((tiles.counts.long() + chunk - 1) // chunk * chunk).sum())
    default = cuda_raster.prepare_tiles(
        *scene, params._replace(layout="flat"), margin_px=1.5)
    print(f"[kernel] flat budget at full width: chunk-padded slots "
          f"{padded}, default budget "
          f"{cuda_raster._flat_capacity_for(params)}, real entries {n_real}, "
          f"dropped {n_real - int(default.counts.sum())}", flush=True)

    ft = cuda_raster.prepare_tiles(
        *scene, params._replace(layout="flat", flat_capacity=n_tiles * k_cap),
        margin_px=1.5)
    if not bool((ft.counts == tiles.counts).all()):
        fail("the T*K flat budget dropped entries")
    ids, starts = ft.flat_ids, ft.starts[None]
    n_owned = int(ft.starts[-1])
    owned_bytes = n_owned * 4 + (n_owned // chunk) * p_tile * 4 \
        + nbytes(starts)                     # ids, tbound rows, starts
    kw = dict(chunk=chunk, width=W, with_median=False, with_dist=False)
    args7 = (F, ids, starts, tiles.rays_t, tiles.pix_t)
    out7, tb7 = kernels.raster_fwd_flat(*args7, **kw)
    out7_p, tb7_p = kernels.raster_fwd_flat_plain(*args7, **kw)
    torch.cuda.synchronize()
    # K1's tolerance against its plain version, for the same reason
    err7 = max(float((out7 - out7_p).abs().max()),
               float((tb7 - tb7_p).abs().max()))
    tol7 = 1e-5 * max(1.0, float(out7_p.abs().max()))
    err71 = float((out7 - out1).abs().max())
    print(f"[kernel] K7_fwd_flat[main] vs K1: max_abs_err {err71:.3e} "
          f"(tol {tol7:.3e}); owned slots {n_owned} of budget "
          f"{ids.numel()}", flush=True)
    if not err71 <= tol7:
        fail(f"K7 disagrees with K1: {err71} > {tol7}")
    ms7 = time_ms(lambda: kernels.raster_fwd_flat(*args7, **kw))
    pms7 = event_ms(lambda: kernels.raster_fwd_flat_plain(*args7, **kw), 3)
    report("K7_fwd_flat[main]", err7, tol7, ms7, pms7)
    b7, by7 = bound(nbytes(F, tiles.rays_t, tiles.pix_t, out7) + owned_bytes,
                    pairs * FWD_OPS_PER_PAIR)
    results["K7_fwd_flat"] = dict(max_abs_err=err7, ms=ms7, plain_ms=pms7,
                                  bound_ms=b7, bound_by=by7, library_ms=None)

    bkw = dict(chunk=chunk, width=W, with_dist=False)
    args8 = (*args7, tb7, out7, g)
    rows = kernels.raster_bwd_flat(*args8, **bkw)
    rows_p = kernels.raster_bwd_flat_plain(*args8, **bkw)
    torch.cuda.synchronize()
    # K2's tolerance against its plain version, for the same reason; K8
    # leaves the rows of the unowned budget chunks unwritten
    err8 = float((rows - rows_p)[:n_owned].abs().max())
    tol8 = 2e-3 * float(rows_p.abs().max())
    ms8 = time_ms(lambda: kernels.raster_bwd_flat(*args8, **bkw))
    pms8 = event_ms(lambda: kernels.raster_bwd_flat_plain(*args8, **bkw), 3)
    report("K8_bwd_flat[main]", err8, tol8, ms8, pms8)
    # what K8's trim of each tile's trailing pads saves: K2 over the real
    # counts and over the chunk-padded ones (the pads composited), in turns
    padded = (tiles.counts + chunk - 1) // chunk * chunk
    bargs2 = (F, tiles.lists, tiles.counts, tiles.rays_t, tiles.pix_t,
              fwd[1], out1, g)
    bargs2p = (*bargs2[:2], padded.to(torch.int32), *bargs2[3:])
    t2 = [time_ms(lambda: kernels.raster_bwd(*bargs2, **bkw)),
          time_ms(lambda: kernels.raster_bwd(*bargs2p, **bkw))]
    t2 += [time_ms(lambda: kernels.raster_bwd(*bargs2p, **bkw)),
           time_ms(lambda: kernels.raster_bwd(*bargs2, **bkw))]
    print(f"[kernel] trailing pads: K2 over the real counts {t2[0]:.4f}/"
          f"{t2[3]:.4f} ms, over the chunk-padded counts (pads composited) "
          f"{t2[1]:.4f}/{t2[2]:.4f} ms; K8 (pads skipped) {ms8:.4f} ms",
          flush=True)
    b8, by8 = bound(nbytes(F, tiles.rays_t, tiles.pix_t, out7, g)
                    + owned_bytes + n_owned * 64, pairs * BWD_OPS_PER_PAIR)
    results["K8_bwd_flat"] = dict(max_abs_err=err8, ms=ms8, plain_ms=pms8,
                                  bound_ms=b8, bound_by=by8, library_ms=None)

    dF9 = kernels.scatter_rows_flat(rows, ids, starts, n_rows)
    dF9_p = kernels.scatter_rows_flat_plain(rows, ids, starts, n_rows)
    torch.cuda.synchronize()
    err9 = float((dF9 - dF9_p).abs().max())
    tol9 = 1e-5 * max(1.0, float(dF9_p.abs().max()))
    err94 = float((dF9 - dF4)[:-1].abs().max())
    print(f"[kernel] K8 + K9 vs K2 + K4 kernels: max_abs_err {err94:.3e} "
          f"(tol {tol_sum:.3e})", flush=True)
    if not err94 <= tol_sum:
        fail(f"K8 + K9 disagree with K2 + K4: {err94} > {tol_sum}")
    summed = kernels._flat_summed_slots(ids, starts, n_rows)
    ids_s, rows_s = ids[summed].long(), rows[summed]
    pms9 = event_ms(lambda: kernels.scatter_rows_flat_plain(rows, ids, starts,
                                                            n_rows))
    ms9, lib9 = yardstick(
        "K9", lambda: kernels.scatter_rows_flat(rows, ids, starts, n_rows),
        lambda: rows.new_zeros((n_rows, 16)).index_add_(0, ids_s, rows_s))
    report("K9_scatter_rows_flat[main]", err9, tol9, ms9, pms9, lib9)
    check_flat_rows_contract(kernels, args8, bkw, n_rows)
    # K4's rule: the rows and ids of the slots it sums (owned, not pads)
    # read once, the pool written once; the earlier bound read every owned
    # slot's row and id
    n_sum = int(summed.sum())
    b9, by9 = bound(n_sum * (64 + 4) + nbytes(starts) + n_rows * 64,
                    n_sum * 16)
    b9_owned = bound(n_owned * (64 + 4) + n_rows * 64, n_owned * 16)[0]
    print(f"[kernel] K9 bound: {b9:.4f} ms ({by9}) over the {n_sum} summed "
          f"slots (owned, not pads); {b9_owned:.4f} ms over all {n_owned} "
          f"owned slots (the earlier bound)", flush=True)
    results["K9_scatter_rows_flat"] = dict(
        max_abs_err=err9, ms=ms9, plain_ms=pms9, bound_ms=b9, bound_by=by9,
        library_ms=lib9)

    tps = 8
    args10 = (dFg, tiles.lists, tiles.counts, n_rows)
    dF10 = kernels.scatter_rows_tps(*args10, tps)
    dF10_p = kernels.scatter_rows_plain(*args10)
    torch.cuda.synchronize()
    err10 = float((dF10 - dF10_p).abs().max())
    err104 = float((dF10 - dF4).abs().max())
    # one kernel launch under two names: a check of the wrapper's routing
    print(f"[kernel] K10 (tps {tps}) vs K4 (the same launch): "
          f"max_abs_err {err104:.3e} (tol {tol_sum:.3e})", flush=True)
    if not err104 <= tol_sum:
        fail(f"K10 disagrees with K4: {err104} > {tol_sum}")
    real = (torch.arange(k_cap, device=dFg.device)[None, :]
            < tiles.counts[:, None])
    ids_real = tiles.lists[real].long()
    rows_real = dFg[real]
    pms10 = event_ms(lambda: kernels.scatter_rows_plain(*args10))
    ms10, lib10 = yardstick(
        f"K10 (tps {tps})", lambda: kernels.scatter_rows_tps(*args10, tps),
        lambda: dFg.new_zeros((n_rows, 16)).index_add_(0, ids_real,
                                                       rows_real))
    report(f"K10_scatter_rows_tps[main, tps {tps}]", err10, tol_sum, ms10,
           pms10, lib10)
    results["K10_scatter_rows_tps"] = dict(
        max_abs_err=err10, ms=ms10, plain_ms=pms10, bound_ms=k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=lib10)
    return results


def check_scatter_adversarial(dev, kernels, cuda_raster, tiles,
                              n_rows) -> None:
    """Phase 1, K6 and K10 on adversarial inputs at the main path's size,
    each against its plain version and against K4.  The rows are small
    integers made from the seed, so every order of summation gives the
    same float32 sums exactly: a disagreement is a fault, not rounding.
      * K6: one surfel owning all 131,072 overflow entries (one run as
        long as the capacity); the full-width occurrence plan with n_ov 0,
        1 and its own count, in id order and with its live entries
        shuffled (no runs left);
      * K10: the main path's tiles at tps 1, 2, 8 and T."""
    lists, counts = tiles.lists, tiles.counts
    n_tiles, k_cap = lists.shape
    gen = np.random.default_rng(SEED + 1)
    rows = torch.tensor(gen.integers(-8, 9, (n_tiles * k_cap + 1, 16),
                                     dtype=np.int8), device=dev).float()
    rows[-1] = 0.0

    def via_k4(slots, ids, n):
        """K4 over the entries (slots, ids)[:n], laid out as 256-slot
        tiles."""
        t = max(1, -(-n // 256))
        lists4 = torch.zeros(t * 256, dtype=torch.int32, device=dev)
        lists4[:n] = ids[:n]
        dFg4 = rows.new_zeros((t * 256, 16))
        dFg4[:n] = rows[slots[:n].long()]
        counts4 = torch.clamp(n - 256 * torch.arange(t, device=dev), 0,
                              256).to(torch.int32)
        return kernels.scatter_rows(dFg4.reshape(t, 256, 16),
                                    lists4.reshape(t, 256), counts4, n_rows)

    def check(name, out, plain, k4):
        torch.cuda.synchronize()
        peak = float(plain.abs().max())
        tol = 1e-5 * max(1.0, peak)
        err = float((out - plain).abs().max())
        err4 = float((out - k4).abs().max())
        print(f"[adversarial] {name}: max_abs_err {err:.3e} vs plain, "
              f"{err4:.3e} vs K4 (tol {tol:.3e}, max|dF| {peak:.1f})",
              flush=True)
        if not (err <= tol and err4 <= tol):
            fail(f"{name}: {err} vs plain, {err4} vs K4 > {tol}")

    plan = cuda_raster.scatter_plan(lists, n_rows - 1)
    cap, n_live = plan.ov_ids.numel(), int(plan.n_ov)
    hot_slots = torch.tensor(gen.permutation(n_tiles * k_cap)[:cap]
                             .astype(np.int32), device=dev)
    hot_ids = torch.full((cap,), n_rows // 2, dtype=torch.int32, device=dev)
    perm = torch.cat([torch.tensor(gen.permutation(n_live), device=dev),
                      torch.arange(n_live, cap, device=dev)])
    cases = [
        ("one surfel owns all entries", hot_slots, hot_ids, cap),
        ("plan, n_ov 0", plan.ov_slots, plan.ov_ids, 0),
        ("plan, n_ov 1", plan.ov_slots, plan.ov_ids, 1),
        ("plan, in id order", plan.ov_slots, plan.ov_ids, n_live),
        ("plan, shuffled", plan.ov_slots[perm], plan.ov_ids[perm], n_live)]
    for name, slots, ids, n in cases:
        args = (rows, slots, ids, torch.tensor(n, dtype=torch.int32,
                                               device=dev), n_rows)
        check(f"K6 {name} (n_ov {n} of {cap})",
              kernels.scatter_overflow(*args),
              kernels.scatter_overflow_plain(*args), via_k4(slots, ids, n))
        if n > 1:
            ids_l, rows_n = ids[:n].long(), rows[slots[:n].long()]
            yardstick(f"K6 {name}", lambda: kernels.scatter_overflow(*args),
                      lambda: rows.new_zeros((n_rows, 16)).index_add_(
                          0, ids_l, rows_n))

    dFg = rows[:-1].reshape(n_tiles, k_cap, 16)
    plain = kernels.scatter_rows_plain(dFg, lists, counts, n_rows)
    k4 = kernels.scatter_rows(dFg, lists, counts, n_rows)
    for tps in (1, 2, 8, n_tiles):
        check(f"K10 tps {tps}",
              kernels.scatter_rows_tps(dFg, lists, counts, n_rows, tps),
              plain, k4)

    # K4 over more tiles than a CUDA grid has rows (65,535)
    big = 70_000
    lists_b = torch.tensor(gen.integers(0, n_rows - 1, (big, 64),
                                        dtype=np.int32), device=dev)
    counts_b = torch.tensor(gen.integers(0, 65, big, dtype=np.int32),
                            device=dev)
    dFg_b = torch.tensor(gen.integers(-8, 9, (big, 64, 16), dtype=np.int8),
                         device=dev).float()
    plain_b = kernels.scatter_rows_plain(dFg_b, lists_b, counts_b, n_rows)
    k4_b = kernels.scatter_rows(dFg_b, lists_b, counts_b, n_rows)
    torch.cuda.synchronize()
    err_b = float((k4_b - plain_b).abs().max())
    tol_b = 1e-5 * max(1.0, float(plain_b.abs().max()))
    print(f"[adversarial] K4 over {big} tiles of 64 slots: max_abs_err "
          f"{err_b:.3e} vs plain (tol {tol_b:.3e})", flush=True)
    if not err_b <= tol_b:
        fail(f"K4 over {big} tiles: {err_b} > {tol_b}")


def flat_of_tiles(lists, counts, tb, chunk: int, pad_id: int):
    """The tiled lists as a flat layout whose tiles own their
    chunk-padded slots, so K8 replays K2's slots:
    (ids [T*K], starts [1, T+1], tbound [T*K/chunk, P], pos [T, K] the flat
    slot of each tiled slot, owned [T, K])."""
    n_tiles, k_cap = lists.shape
    dev = lists.device
    span = (counts.long() + chunk - 1) // chunk * chunk
    starts = torch.zeros(n_tiles + 1, dtype=torch.long, device=dev)
    starts[1:] = torch.cumsum(span, 0)
    j = torch.arange(k_cap, device=dev)
    owned = j[None, :] < span[:, None]
    pos = starts[:-1, None] + j[None, :]
    ids = torch.full((n_tiles * k_cap,), pad_id, dtype=torch.int32,
                     device=dev)
    ids[pos[owned]] = lists[owned]
    ci = torch.arange(k_cap // chunk, device=dev)
    ch_owned = ci[None, :] < (span // chunk)[:, None]
    tbf = tb.new_zeros((n_tiles * k_cap // chunk, tb.shape[1]))
    tbf[(starts[:-1, None] // chunk + ci[None, :])[ch_owned]] = \
        tb.transpose(1, 2)[ch_owned]
    return ids, starts[None].int(), tbf, pos, owned


def check_tiles_adversarial(dev, kernels, binning, common, scene, tiles,
                            chunk) -> None:
    """Phase 1, K1, K7, K2, K5 and K8 on adversarial inputs at the main
    path's width.  K1 with neither and with both of the median and the
    distortion term, against its plain version, and K1 and K7 against the
    plain version in float64 (``check_fwd``); K2, K5 and K8 with and
    without the distortion term,
    against the plain version in float64 at 2e-3 * max|ref64| (the repo's
    gradient tolerance, ``hold_bwd_to_float64``):
      * the main path's tiles;
      * every third tile empty and every third filled to K slots;
      * 16 tiles led by six opaque surfels stacked half a pixel beside a
        pixel's ray (T under T_EPS after the first chunk, alpha_raw >=
        0.999 at that pixel), filled to K slots;
      * one K-slot tile among empty ones."""
    from splatloam_tpu_torch.geometry import se3
    gen = np.random.default_rng(SEED + 2)
    n_tiles, k_cap = tiles.lists.shape
    n = scene[0].shape[0]
    rays, pix = tiles.rays_t, tiles.pix_t
    op_tiles = (torch.arange(16, device=dev) * (n_tiles // 16)
                + n_tiles // 32)
    depth = 1.0 + 0.05 * torch.arange(6, device=dev, dtype=torch.float32)
    ray = rays[op_tiles, 8]                                    # [16, 3]
    side = torch.linalg.cross(ray, torch.tensor([0.0, 0.0, 1.0],
                                                device=dev).expand_as(ray))
    side = side / torch.linalg.norm(side, dim=-1, keepdim=True)
    xyz = ((ray[:, None] + np.pi / W * side[:, None])
           * depth[None, :, None]).reshape(-1, 3)
    extra = (xyz, torch.full((96, 2), 4.0, device=dev),
             se3.quat_from_normal(-ray.repeat_interleave(6, 0)),
             torch.full((96,), 0.99999, device=dev))
    F = binning.pack_features(common.pack_surfels(
        *(torch.cat([a, b]) for a, b in zip(scene[:4], extra)),
        *scene[4:])).contiguous()
    pad = F.shape[0] - 1
    base = torch.where(tiles.lists == n, pad, tiles.lists)
    fill = torch.tensor(gen.integers(0, n, (n_tiles, k_cap)),
                        dtype=torch.int32, device=dev)
    real = (torch.arange(k_cap, device=dev)[None, :]
            < tiles.counts[:, None])
    full = torch.where(real, base, fill)
    third = torch.arange(n_tiles, device=dev) % 3
    stack = full.clone()
    stack[op_tiles, :6] = (n + torch.arange(96, device=dev, dtype=torch.int32)
                           ).reshape(16, 6)
    stacked = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    stacked[op_tiles] = True
    kfull = torch.full_like(tiles.counts, k_cap)
    zero = torch.zeros_like(tiles.counts)
    lone = zero.clone()
    lone[n_tiles // 2] = k_cap
    cases = [("main tiles", base, tiles.counts),
             ("counts 0 and K", torch.where((third == 1)[:, None], full,
                                            base),
              torch.where(third == 0, zero,
                          torch.where(third == 1, kfull, tiles.counts))),
             ("opaque stacks", torch.where(stacked[:, None], stack, base),
              torch.where(stacked, kfull, tiles.counts)),
             ("one K-slot tile among empty ones", full, lone)]
    for name, lists, counts in cases:
        lists = torch.where(torch.arange(k_cap, device=dev)[None, :]
                            < counts[:, None], lists, pad).contiguous()
        counts = counts.contiguous()
        for flags in (False, True):
            check_fwd(f"K1 {name}", kernels, (F, lists, counts, rays, pix),
                      chunk, flags, flags, tag="adversarial")
        for dist in (False, True):
            g = torch.tensor(gen.normal(size=(n_tiles, rays.shape[1], 8))
                             .astype(np.float32), device=dev)
            tb = hold_bwd_to_float64(f"[adversarial] {name}", kernels,
                                     common, (F, lists, counts, rays, pix), g,
                                     chunk, dist)
            if name == "opaque stacks":
                dead = float(tb[op_tiles][:, :, 1:].max())
                print(f"[adversarial] K2 opaque stacks, with_dist {dist}: "
                      f"the stacked tiles' later chunk-start T {dead:.1e}",
                      flush=True)
                if not dead <= common.T_EPS:
                    fail("the opaque stacks left a later chunk live")


def float64_ties(kernels, common, bargs, chunk):
    """[T, K] bool: the live slots holding a (pixel, slot) pair whose
    branch of the splat geometry comes out one way in the float32 plain
    version and the other in float64: the min of the screen filter and
    the ellipse, the alpha cut (1/255, the near plane) or the clamp at
    0.999.  At such a tie the two precisions differentiate two different
    functions (the filter's and the ellipse's gradients differ in kind),
    and the tie reaches every earlier slot of that pixel through the
    suffix sums.  Also returns the number of tied pairs of each kind."""
    F, lists, counts, rays, pix, tb = bargs[:6]
    n_live = kernels._live_chunks(counts, tb, chunk)
    tie = torch.zeros(lists.shape, dtype=torch.bool, device=lists.device)
    kinds = dict(filter=0, cut=0, clamp=0)
    for i in range(int(n_live.max()) if n_live.numel() else 0):
        cols = slice(i * chunk, (i + 1) * chunk)
        Fc = F[lists[:, cols].long()]
        g32 = kernels._splat_geometry(Fc, rays, pix, W)
        g64 = kernels._splat_geometry(Fc.double(), rays.double(),
                                      pix.double(), W)
        live = (i < n_live)[:, None, None]
        flips = dict(filter=g32["use2"] != g64["use2"],
                     cut=g32["ok"] != g64["ok"],
                     clamp=((g32["alpha_raw"] < common.ALPHA_MAX)
                            != (g64["alpha_raw"] < common.ALPHA_MAX)))
        for k, f in flips.items():
            f = f & live
            kinds[k] += int(f.sum())
            tie[:, cols] |= f.any(dim=1)
    return tie, kinds


def hold_bwd_to_float64(name, kernels, common, fwd_args, g, chunk: int,
                        dist: bool):
    """K2, K5 and K8, one slot-parallel body in its three write modes,
    each against the plain version in float64 at 2e-3 * max|ref64| (the
    repo's gradient tolerance), on K1's forward of ``fwd_args`` (F, lists,
    counts, rays, pix) and cotangents ``g``: K2's rows of the real slots;
    K5's pool against the float64 rows reduced by id; K8's rows over the
    same slots as a flat layout (``flat_of_tiles``).  The float32 plain
    version's error is printed beside.  Tiles holding a float32/float64
    branch tie (``float64_ties``) are held apart, and for K5 the surfels
    that occur in them; every other tile and surfel must agree.  Where
    there are ties, the tied surfels are then moved off them (0.01 px
    along the image's u, opacity times 0.999) and the three are held to
    float64 again on the new inputs.  Returns K1's tbound."""
    F, lists, counts, rays, pix = fwd_args
    n_tiles, k_cap = lists.shape
    n_rows = F.shape[0]
    bkw = dict(chunk=chunk, width=W, with_dist=dist)
    real = (torch.arange(k_cap, device=lists.device)[None, :]
            < counts[:, None])

    def forward_and_float64(F):
        args = (F, lists, counts, rays, pix)
        out, tb = kernels.raster_fwd(*args, chunk=chunk, width=W,
                                     with_median=False, with_dist=dist)
        bargs = (*args, tb, out, g)
        d64 = kernels.raster_bwd_plain(
            *(a.double() if a.is_floating_point() else a for a in bargs),
            **bkw)
        return bargs, d64, *float64_ties(kernels, common, bargs, chunk)

    def three(bargs):
        """K2's rows, K5's pool and K8's rows as [T, K, 16]."""
        F, tb, out = bargs[0], bargs[5], bargs[6]
        ids, starts, tbf, pos, owned = flat_of_tiles(lists, counts, tb,
                                                     chunk, n_rows - 1)
        rows8 = kernels.raster_bwd_flat(F, ids, starts, rays, pix, tbf, out,
                                        g, **bkw)
        d8 = rows8.new_zeros((n_tiles, k_cap, 16))
        d8[owned] = rows8[pos[owned].long()]
        return (kernels.raster_bwd(*bargs, **bkw),
                kernels.raster_bwd_fused(*bargs, n_rows, **bkw), d8)

    def hold(bargs, d64, tie):
        """[(error, tolerance, held-apart error)] of K2, K5, K8 and the
        float32 plain version's rows and pool."""
        tied = tie.any(dim=1)
        keep = (~tied)[:, None] & real
        pool64 = kernels.scatter_rows_plain(d64, lists, counts, n_rows)
        keep5 = torch.ones(n_rows, dtype=torch.bool, device=F.device)
        keep5[lists[tied[:, None] & real].long()] = False
        d2, d5, d8 = three(bargs)
        d32 = kernels.raster_bwd_plain(*bargs, **bkw)
        p32 = kernels.scatter_rows_plain(d32, lists, counts, n_rows)
        torch.cuda.synchronize()

        def err(d, ref, mask):
            return float((d - ref)[mask].abs().max()) if bool(mask.any()) \
                else 0.0

        tol, tol5 = (2e-3 * float(x.abs().max()) for x in (d64, pool64))
        return [(err(d2, d64, keep), tol, err(d2, d64, ~keep & real)),
                (err(d5, pool64, keep5), tol5, err(d5, pool64, ~keep5)),
                (err(d8, d64, keep), tol, err(d8, d64, ~keep & real)),
                (err(d32, d64, keep), tol, err(d32, d64, ~keep & real)),
                (err(p32, pool64, keep5), tol5, err(p32, pool64, ~keep5))]

    def check(res, what, n_kept):
        labels = ("K2", "K5 pool", "K8", "float32 plain", "its pool")
        parts = ", ".join(f"{lb} {e:.3e} (tol {t:.3e})"
                          for lb, (e, t, _) in zip(labels, res))
        print(f"{name}, with_dist {dist}{what}: max_abs_err vs float64 "
              f"plain: {parts}; over {n_kept} of {n_tiles} tiles", flush=True)
        for lb, (e, t, _) in zip(labels[:3], res):
            if not e <= t:
                fail(f"{name}, with_dist {dist}{what}: {lb} {e} > {t}")

    bargs, d64, tie, kinds = forward_and_float64(F)
    tied = tie.any(dim=1)
    res = hold(bargs, d64, tie)
    check(res, "", n_tiles - int(tied.sum()))
    if bool(tied.any()):
        print(f"{name}, with_dist {dist}: held apart, {int(tied.sum())} "
              f"tiles with float32/float64 branch ties (pairs {kinds}): "
              f"K2 {res[0][2]:.3e}, K5 pool {res[1][2]:.3e}, K8 "
              f"{res[2][2]:.3e}, float32 plain {res[3][2]:.3e}", flush=True)
        ids_tied = lists[tie].long().unique()
        Fn = F.clone()
        Fn[ids_tied, 14] += 0.01
        Fn[ids_tied, 12] *= 0.999
        bargs_n, d64_n, tie_n, kinds_n = forward_and_float64(Fn)
        res_n = hold(bargs_n, d64_n, tie_n)
        check(res_n, f", the {ids_tied.numel()} tied surfels moved off "
              f"their ties (ties left {kinds_n})",
              n_tiles - int(tie_n.any(dim=1).sum()))
    return bargs[5]


def check_fused_and_overflow(dev, kernels, binning, cuda_raster, tiles,
                             bargs, bkw, dFg, dF4, n_rows, n_comp, pairs,
                             rs_step) -> dict:
    """Phase 1, K5 and K6 at the main path's shapes, on the tiles and the
    K2 rows of check_kernels; K4's result dF4 is the reduction oracle."""
    results = {}
    rows = dFg.reshape(-1, 16)
    # sums of the same rows in another order (atomics: run-dependent)
    tol_sum = 1e-5 * max(1.0, float(dF4.abs().max()))

    dF5 = kernels.raster_bwd_fused(*bargs, n_rows, **bkw)
    dF5_p = kernels.raster_bwd_fused_plain(*bargs, n_rows, **bkw)
    torch.cuda.synchronize()
    # K2's tolerance against its plain version, for the same reason
    err5 = float((dF5 - dF5_p).abs().max())
    tol5 = 2e-3 * float(dF5_p.abs().max())
    err54 = float((dF5 - dF4).abs().max())
    print(f"[kernel] K5_bwd_fused[main] vs K2 + K4 kernels: max_abs_err "
          f"{err54:.3e} (tol {tol_sum:.3e})", flush=True)
    if not err54 <= tol_sum:
        fail(f"K5 disagrees with K2 + K4: {err54} > {tol_sum}")
    ms5 = time_ms(lambda: kernels.raster_bwd_fused(*bargs, n_rows, **bkw))
    pms5 = event_ms(lambda: kernels.raster_bwd_fused_plain(*bargs, n_rows,
                                                          **bkw), 3)
    report("K5_bwd_fused[main]", err5, tol5, ms5, pms5)
    # K2's inputs, one 64-byte atomic row per composited slot, the pool
    # written once
    b5, by5 = bound(nbytes(*bargs) + (n_comp + n_rows) * 64,
                    pairs * BWD_OPS_PER_PAIR)
    results["K5_bwd_fused"] = dict(max_abs_err=err5, ms=ms5, plain_ms=pms5,
                                   bound_ms=b5, bound_by=by5,
                                   library_ms=None)

    # K6 under the full-width occurrence plan (prepare_tiles' ov_cap)
    lists = tiles.lists
    plan = cuda_raster.scatter_plan(lists, n_rows - 1)
    ov_cap = plan.ov_slots.numel()
    occ = torch.bincount(lists.reshape(-1).long(), minlength=n_rows)[:-1]
    uncapped = int(torch.clamp(occ - cuda_raster.PLAN_M, min=0).sum())
    n_ov = int(plan.n_ov)
    print(f"[kernel] plan overflow at full width: n_ov {uncapped} uncapped, "
          f"ov_cap {ov_cap}, kept {n_ov}, dropped {uncapped - n_ov}",
          flush=True)
    if n_ov == 0:
        fail("the full-width plan has no overflow: K6 would do no work")
    # K6 gathers each entry's row from rows1 itself; its index_add_ gets
    # the same gather
    rows1 = torch.cat([rows, rows.new_zeros((1, 16))])
    args6 = (rows1, plan.ov_slots, plan.ov_ids, plan.n_ov, n_rows)
    dF6 = kernels.scatter_overflow(*args6)
    dF6_p = kernels.scatter_overflow_plain(*args6)
    torch.cuda.synchronize()
    slots6, ids6 = plan.ov_slots[:n_ov].long(), plan.ov_ids[:n_ov].long()
    err6 = float((dF6 - dF6_p).abs().max())
    tol6 = 1e-5 * max(1.0, float(rows1[slots6].abs().max()))
    dF_plan = cuda_raster._scatter_with_plan(rows, plan, n_rows)
    err_p4 = float((dF_plan - dF4)[:-1].abs().max())
    print(f"[kernel] plan gather + K6 vs K4: max_abs_err {err_p4:.3e} "
          f"(tol {tol_sum:.3e})", flush=True)
    if not err_p4 <= tol_sum:
        fail(f"plan gather + K6 disagrees with K4: {err_p4} > {tol_sum}")
    pms6 = event_ms(lambda: kernels.scatter_overflow_plain(*args6))
    ms6, lib6 = yardstick(
        "K6 (gather fused)", lambda: kernels.scatter_overflow(*args6),
        lambda: rows.new_zeros((n_rows, 16)).index_add_(0, ids6,
                                                        rows1[slots6]))
    report("K6_scatter_overflow[plan]", err6, tol6, ms6, pms6, lib6)
    # each live entry's row, slot and id read once; the pool written once
    b6, by6 = bound(n_ov * (64 + 4 + 4) + n_rows * 64, n_ov * 16)
    results["K6_scatter_overflow"] = dict(max_abs_err=err6, ms=ms6,
                                          plain_ms=pms6, bound_ms=b6,
                                          bound_by=by6, library_ms=lib6)

    # K3 + K6 under a truncated ranksum plan: keep the last step multiple
    # below the real slot count, so 0 < spilled real entries <= ov_cap
    n_real = int(tiles.counts.sum())
    e_cap = (n_real - 1) // rs_step * rs_step
    trunc = (e_cap + rs_step / 2) / lists.numel()
    tplan = cuda_raster.RanksumPlan(*binning.build_ranksum_plan(
        lists, n_rows - 1, group=cuda_raster.RS_GROUP,
        gps=cuda_raster.RS_GPS, trunc_frac=trunc))
    n_ov_t = int(tplan.n_ov)
    dF_t = cuda_raster._reduce_rows_with_ranksum(rows, tplan, n_rows)
    torch.cuda.synchronize()
    err_t4 = float((dF_t - dF4)[:-1].abs().max())
    print(f"[kernel] truncated ranksum: trunc_frac {trunc:.6f}, kept "
          f"{tplan.pos.numel()} of {lists.numel()} entries, real {n_real}, "
          f"n_ov {n_ov_t} (ov_cap {tplan.ov_slots.numel()}); K3 + K6 vs K4: "
          f"max_abs_err {err_t4:.3e} (tol {tol_sum:.3e})", flush=True)
    if n_ov_t <= 0:
        fail("the truncated plan spilled no real entry")
    if not err_t4 <= tol_sum:
        fail(f"truncated K3 + K6 disagrees with K4: {err_t4} > {tol_sum}")
    return results


def time_bwd_with_dist(kernels, params, tiles, F, fwd_dist, g,
                       n_rows) -> None:
    """Phase 1: K2, K5 and K8 at the main path's shapes with the
    distortion term (the render API's default), on K1's forward
    ``fwd_dist`` (out, tbound) with both flags; K8 over the tiles'
    chunk-padded slots as a flat layout (``flat_of_tiles``: the drop-free
    budget's layout)."""
    out, tb = fwd_dist
    lists, counts = tiles.lists, tiles.counts
    bkw = dict(chunk=params.chunk, width=W, with_dist=True)
    bargs = (F, lists, counts, tiles.rays_t, tiles.pix_t, tb, out, g)
    ids, starts, tbf = flat_of_tiles(lists, counts, tb, params.chunk,
                                     n_rows - 1)[:3]
    args8 = (F, ids, starts, tiles.rays_t, tiles.pix_t, tbf, out, g)
    ms = [time_ms(lambda: kernels.raster_bwd(*bargs, **bkw)),
          time_ms(lambda: kernels.raster_bwd_fused(*bargs, n_rows, **bkw)),
          time_ms(lambda: kernels.raster_bwd_flat(*args8, **bkw))]
    print(f"[kernel] backward body with the distortion term at the main "
          f"path's shapes (graph replay): K2 {ms[0]:.4f}, K5 {ms[1]:.4f}, "
          f"K8 {ms[2]:.4f} ms", flush=True)


def check_rows_past_count(kernels, binning, cuda_raster, tiles, dFg, n_rows,
                          rs_step) -> None:
    """Phase 1: K2 leaves the rows past each tile's count unwritten.  Every
    reduction of its rows (K3 on the tiled ranksum plan, K4, K10 at tps 8,
    the occurrence plan's gather + K6, the truncated ranksum plan's K3 +
    K6) gives the same dF with those rows set to NaN as with them set to
    0, within 1e-5 * max(1, max|dF|) (the atomics' order varies)."""
    lists, counts = tiles.lists, tiles.counts
    real = (torch.arange(lists.shape[1], device=lists.device)[None, :]
            < counts[:, None])
    nan, zero = dFg.clone(), dFg.clone()
    nan[~real] = float("nan")
    zero[~real] = 0.0
    n_real = int(counts.sum())
    e_cap = (n_real - 1) // rs_step * rs_step
    tplan = cuda_raster.RanksumPlan(*binning.build_ranksum_plan(
        lists, n_rows - 1, group=cuda_raster.RS_GROUP, gps=cuda_raster.RS_GPS,
        trunc_frac=(e_cap + rs_step / 2) / lists.numel()))
    splan = cuda_raster.scatter_plan(lists, n_rows - 1)
    reductions = [
        ("K3 on the ranksum plan", lambda d: cuda_raster
         ._reduce_rows_with_ranksum(d.reshape(-1, 16), tiles.plan, n_rows)),
        ("K4", lambda d: kernels.scatter_rows(d, lists, counts, n_rows)),
        ("K10 (tps 8)", lambda d: kernels.scatter_rows_tps(d, lists, counts,
                                                           n_rows, 8)),
        ("occurrence plan gather + K6", lambda d: cuda_raster
         ._scatter_with_plan(d.reshape(-1, 16), splan, n_rows)),
        ("truncated ranksum plan, K3 + K6", lambda d: cuda_raster
         ._reduce_rows_with_ranksum(d.reshape(-1, 16), tplan, n_rows))]
    parts = []
    for name, fn in reductions:
        a, b = fn(nan), fn(zero)
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        tol = 1e-5 * max(1.0, float(b.abs().max()))
        parts.append(f"{name} {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            fail(f"{name} reads K2's rows past the count: {err} > {tol}")
    print(f"[kernel] K2's {int((~real).sum())} rows past the counts set to "
          f"NaN, each reduction against the same rows set to 0: "
          f"{', '.join(parts)}", flush=True)


def check_flat_rows_contract(kernels, args8, bkw, n_rows) -> None:
    """Phase 1: K8 writes every row that K9 reads, in the same call, and K9
    reads no other (pads, budget chunks no tile owns).  K8's launcher into
    a rows buffer filled with NaN, then K9, against K8 into a zero-filled
    buffer, then K9; and K9 on those zero-filled rows with every row it
    must not read set to NaN.  Each within 1e-5 * max(1, max|dF|) (the
    atomics' order varies)."""
    F, ids, starts = args8[:3]
    summed = kernels._flat_summed_slots(ids, starts, n_rows)

    def k8_into(fill):
        rows = torch.full((ids.shape[0], 16), fill, device=F.device)
        return kernels._launch_bwd_flat(rows, *args8, bkw["chunk"],
                                        bkw["width"], bkw["with_dist"])

    zero = k8_into(0.0)
    ref = kernels.scatter_rows_flat(zero, ids, starts, n_rows)
    skipped = torch.where(summed[:, None], zero, float("nan"))
    cases = [("K8 into NaN-filled rows, then K9",
              kernels.scatter_rows_flat(k8_into(float("nan")), ids, starts,
                                        n_rows)),
             (f"K9 with the {int((~summed).sum())} rows it must not read "
              f"set to NaN", kernels.scatter_rows_flat(skipped, ids, starts,
                                                       n_rows))]
    torch.cuda.synchronize()
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    parts = []
    for what, dF in cases:
        err = float((dF - ref).abs().max())
        parts.append(f"{what} {err:.3e}")
        if not err <= tol:
            fail(f"{what}: {err} against a zero-filled buffer > {tol}")
    print(f"[kernel] K8/K9 row contract against K8 into zero-filled rows, "
          f"then K9: {', '.join(parts)} (tol {tol:.3e})", flush=True)


def check_bucketed(dev, kernels, binning, cuda_raster, scene, params, F,
                   n_rows) -> None:
    """Phase 1, the render API's bucketed layout at the main path's shapes
    (the default bucket_frac and bucket_k_small): K5 on each bucket
    against its plain version (K2's tolerance) and timed; and K3 on the
    bucketed ranksum plan with the rows past each count set to NaN, as in
    ``check_rows_past_count``."""
    bp = params._replace(layout="bucketed", scatter="ranksum")
    bt = cuda_raster.prepare_tiles(*scene, bp, margin_px=1.5)
    static = cuda_raster._StaticArgs(chunk=bp.chunk, width=W,
                                     with_median=False, with_dist=False,
                                     fused=False)
    gen = np.random.default_rng(SEED + 3)
    bkw = dict(chunk=bp.chunk, width=W, with_dist=False)
    buckets = []
    for args in ((F, bt.lists_b, bt.counts_b, bt.rays_b, bt.pix_b),
                 (F, bt.lists_s, bt.counts_s, bt.rays_s, bt.pix_s)):
        out, tb = cuda_raster._forward_tiled(*args, static)
        g = torch.tensor(gen.normal(size=tuple(out.shape)).astype(np.float32),
                         device=dev)
        buckets.append((*args, tb, out, g))
    parts = []
    for label, b in zip(("big", "small"), buckets):
        d5 = kernels.raster_bwd_fused(*b, n_rows, **bkw)
        d5_p = kernels.raster_bwd_fused_plain(*b, n_rows, **bkw)
        torch.cuda.synchronize()
        err = float((d5 - d5_p).abs().max())
        tol = 2e-3 * float(d5_p.abs().max())
        ms = time_ms(lambda: kernels.raster_bwd_fused(*b, n_rows, **bkw))
        parts.append(f"{label} bucket {b[1].shape[0]} tiles x K "
                     f"{b[1].shape[1]}: {ms:.4f} ms, max_abs_err {err:.3e} "
                     f"(tol {tol:.3e})")
        if not err <= tol:
            fail(f"K5 on the {label} bucket: {err} > {tol}")
    both = time_ms(lambda: [kernels.raster_bwd_fused(*b, n_rows, **bkw)
                            for b in buckets])
    print(f"[kernel] K5 on the bucketed layout (graph replay): "
          f"{'; '.join(parts)}; both buckets {both:.4f} ms", flush=True)

    rows = {}
    for fill in ("nan", "zero"):
        parts = []
        for b in buckets:
            d = kernels.raster_bwd(*b, **bkw)
            real = (torch.arange(d.shape[1], device=dev)[None, :]
                    < b[2][:, None])
            d[~real] = float("nan") if fill == "nan" else 0.0
            parts.append(d.reshape(-1, 16))
        rows[fill] = cuda_raster._reduce_rows_with_ranksum(
            torch.cat(parts), bt.plan, n_rows)
    torch.cuda.synchronize()
    err = float((rows["nan"] - rows["zero"]).abs().max())
    print(f"[kernel] K3 on the bucketed ranksum plan, K2's rows past the "
          f"counts set to NaN against 0: max_abs_err {err:.3e} (tol 0: one "
          f"owner per segment, no atomics)", flush=True)
    if not err == 0.0:
        fail(f"K3 reads K2's rows past the count on the bucketed plan: {err}")


def check_render_parity(dev, rng) -> None:
    """Phase 2: render on the cuda backend vs the eager golden renderer,
    values and gradients, on a reduced scene (the tests' tolerances)."""
    from splatloam_tpu_torch.ops.rasterizer.api import (RenderParams,
                                                        rasterize)
    from splatloam_tpu_torch.ops.rasterizer.eager_ref import rasterize_eager

    h, w = 16, 256
    scene = make_scene(rng, 300, h, w, dev)
    xyz = scene[0] * (7.0 / torch.linalg.norm(scene[0], dim=-1,
                                              keepdim=True))
    scene = (xyz, scene[1] * 2.0, *scene[2:])
    params = RenderParams(height=h, width=w, backend="cuda", chunk=128,
                          tile_h=8, tile_w=32, tile_list_capacity=512,
                          scatter="ranksum")

    def loss(c):
        return (c["depth_sum"].sum() * 0.1 + c["alpha"].sum()
                + 0.5 * c["normal_sum"].sum() + 0.2 * c["dist"].sum())

    leaves = [a.clone().requires_grad_(True) for a in scene[:5]]
    out = rasterize(*leaves, scene[5], params)
    g_cuda = torch.autograd.grad(loss(out), leaves)
    leaves_r = [a.clone().requires_grad_(True) for a in scene[:5]]
    ref = rasterize_eager(*leaves_r, scene[5], h, w)
    g_ref = torch.autograd.grad(loss(ref), leaves_r)
    for key, tol in [("alpha", 2e-5), ("depth_sum", 2e-4),
                     ("normal_sum", 2e-4), ("dist", 3e-4)]:
        err = float((out[key] - ref[key]).detach().abs().max())
        print(f"[parity] {key}: max_abs_err {err:.3e} (tol {tol})")
        if not err <= tol:
            fail(f"render {key} disagrees with the eager renderer")
    hold_median("render vs eager", out["median"], ref["median"])
    for name, a, b, rel in zip(["xyz", "scales", "quat", "opacity", "T_cw"],
                               g_cuda, g_ref, [2e-3] * 4 + [3e-3]):
        tol = rel * float(b.abs().max()) + 1e-6
        err = float((a - b).abs().max())
        print(f"[parity] grad {name}: max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            fail(f"render gradient {name} disagrees with the eager renderer")

    # the other reductions and the bucketed and flat layouts against the
    # tiled ranksum render (the same sums in another order:
    # 1e-5 * max(1, max|g|)) and the eager renderer; the bucketed runs keep
    # the small bucket at one chunk (K/C = 1) for the quarter of the tiles
    # with the fewest surfels, the flat run a budget that drops nothing
    from splatloam_tpu_torch.ops.rasterizer.cuda_raster import prepare_tiles
    names = ["xyz", "scales", "quat", "opacity", "T_cw"]
    n_tiles = (h // params.tile_h) * (w // params.tile_w)
    for label, kw in [
            ("fused", dict(scatter="fused")), ("plan", dict(scatter="plan")),
            ("bucketed-fused", dict(layout="bucketed", scatter="fused",
                                    bucket_frac=0.75)),
            ("bucketed-ranksum", dict(layout="bucketed", scatter="ranksum",
                                      bucket_frac=0.75)),
            ("flat", dict(layout="flat", flat_capacity=n_tiles
                          * params.tile_list_capacity))]:
        p = params._replace(**kw)
        tiles = prepare_tiles(*scene, p)
        if label.startswith("bucketed") and \
                int(tiles.counts_s.max()) >= tiles.lists_s.shape[1]:
            fail(f"{label}: a small-bucket tile was cut, so the tiled "
                 "render is no oracle")
        leaves_v = [a.clone().requires_grad_(True) for a in scene[:5]]
        out_v = rasterize(*leaves_v, scene[5], p, tiles=tiles)
        g_v = torch.autograd.grad(loss(out_v), leaves_v)
        if label == "flat":
            errs = []
            for key, tol in [("alpha", 2e-5), ("depth_sum", 2e-4),
                             ("normal_sum", 2e-4), ("dist", 3e-4),
                             ("final_T", 2e-5)]:
                e_t = float((out_v[key] - out[key]).detach().abs().max())
                e_e = float((out_v[key] - ref[key]).detach().abs().max())
                errs.append(f"{key} {e_t:.2e}/{e_e:.2e}")
                if not (e_t <= tol and e_e <= tol):
                    fail(f"flat render {key}: {e_t} vs the tiled render, "
                         f"{e_e} vs eager (tol {tol})")
            print(f"[parity] flat vs tiled render / eager: "
                  f"{', '.join(errs)}", flush=True)
            hold_median("flat vs tiled render", out_v["median"],
                        out["median"])
        errs = []
        for name, a, b, c, rel in zip(names, g_v, g_cuda, g_ref,
                                      [2e-3] * 4 + [3e-3]):
            tol_rs = 1e-5 * max(1.0, float(b.abs().max()))
            tol_e = rel * float(c.abs().max()) + 1e-6
            err_rs = float((a - b).abs().max())
            err_e = float((a - c).abs().max())
            errs.append(f"{name} {err_rs:.2e}/{err_e:.2e}")
            if not (err_rs <= tol_rs and err_e <= tol_e):
                fail(f"{label} gradient {name}: {err_rs} vs the ranksum "
                     f"render (tol {tol_rs}), {err_e} vs eager (tol {tol_e})")
        print(f"[parity] grad {label} vs ranksum render / eager: "
              f"{', '.join(errs)}", flush=True)
    check_render_batch(scene, params, n_tiles)


def hold_median(name, med, med_ref) -> None:
    """The median channel as the JAX package's tests hold it: within 1e-4
    where both cross T = 0.5, and both cross at >= 99% of the pixels where
    the reference does (a pixel whose T sits at 0.5 may cross in one and
    not the other)."""
    med, med_ref = med.detach(), med_ref.detach()
    both = (med > 0) & (med_ref > 0)
    err = float((med - med_ref)[both].abs().max()) if bool(both.any()) \
        else 0.0
    share = int(both.sum()) / max(int((med_ref > 0).sum()), 1)
    print(f"[parity] median {name}: max_abs_err {err:.3e} (tol 1e-4) where "
          f"both cross, on {share:.4f} of the reference's crossing pixels "
          f"(>= 0.99)", flush=True)
    if not (err <= 1e-4 and share >= 0.99):
        fail(f"median {name}: {err} > 1e-4 or {share} < 0.99")


def check_render_batch(scene, params, n_tiles) -> None:
    """Phase 2: render_batch over 3 poses of the reduced scene, tiled under
    each scatter mode and flat, against three single-view renders: values
    within the forward tolerances, gradients (summed over the views for
    the surfels, per view for the poses) at 1e-5 * max(1, max|g|), the
    same sums in another order."""
    from splatloam_tpu_torch.ops.rasterizer.api import render, render_batch

    xyz, sc, quat, opac, T, K = scene
    shift = torch.tensor([[0.0, 0.0, 0.0], [0.3, -0.1, 0.02],
                          [-0.2, 0.25, -0.03]], device=T.device)
    T_b = T[None].repeat(3, 1, 1)
    T_b[:, :3, 3] += shift
    K_b = K[None].repeat(3, 1, 1)

    def loss(pkg):
        return (pkg["rend_alpha"].sum() + 0.2 * pkg["rend_dist"].sum()
                + 0.1 * (pkg["surf_depth"] * pkg["rend_alpha"]).sum())

    keys = [("rend_alpha", 2e-5), ("rend_dist", 3e-4), ("surf_depth", 2e-4),
            ("rend_normal", 2e-4)]
    flat = dict(layout="flat",
                flat_capacity=n_tiles * params.tile_list_capacity)
    for label, kw in [("rmw", dict(scatter="rmw")),
                      ("ranksum", dict(scatter="ranksum")),
                      ("fused", dict(scatter="fused")),
                      ("plan", dict(scatter="plan")), ("flat", flat)]:
        p = params._replace(**kw)
        leaves = [a.clone().requires_grad_(True) for a in (xyz, sc, quat,
                                                           opac, T_b)]
        pkg = render_batch(*leaves, K_b, p)
        g_b = torch.autograd.grad(loss(pkg), leaves)
        leaves_s = [a.clone().requires_grad_(True) for a in (xyz, sc, quat,
                                                             opac, T_b)]
        tot, err_v = 0.0, 0.0
        for v in range(3):
            one = render(*leaves_s[:4], leaves_s[4][v], K, p)
            tot = tot + loss(one)
            for key, tol in keys:
                e = float((pkg[key][v] - one[key]).detach().abs().max())
                err_v = max(err_v, e / tol)
        g_s = torch.autograd.grad(tot, leaves_s)
        errs = []
        for name, a, b in zip(["xyz", "scales", "quat", "opacity", "T_cw"],
                              g_b, g_s):
            tol = 1e-5 * max(1.0, float(b.abs().max()))
            err = float((a - b).abs().max())
            errs.append(f"{name} {err:.2e}")
            if not err <= tol:
                fail(f"render_batch[{label}] gradient {name}: {err} vs "
                     f"three single-view renders (tol {tol})")
        print(f"[parity] render_batch[{label}] B=3 vs single views: values "
              f"{err_v:.3f} of tolerance, grads {', '.join(errs)}",
              flush=True)
        if not err_v <= 1.0:
            fail(f"render_batch[{label}] values disagree with single views")


def street_world(rng, n: int) -> np.ndarray:
    """[n, 3] points of a street canyon (two facades, cross walls, ground,
    poles), 120 m along x."""
    a = n // 5
    x = rng.uniform(-60, 60, 2 * a)
    fac = np.stack([x, np.where(np.arange(2 * a) < a, -9.0, 11.0),
                    rng.uniform(-1.7, 8.0, 2 * a)], -1)
    y = rng.uniform(-9, 11, a)
    cross = np.stack([np.where(np.arange(a) < a // 2, -55.0, 58.0), y,
                      rng.uniform(-1.7, 8.0, a)], -1)
    g = np.stack([rng.uniform(-60, 60, a), rng.uniform(-9, 11, a),
                  np.full(a, -1.7)], -1)
    m = n - 4 * a
    ang = rng.uniform(-np.pi, np.pi, m)
    cx = rng.choice([-30.0, -10.0, 15.0, 35.0], m)
    poles = np.stack([cx + 0.3 * np.cos(ang), 7.0 + 0.3 * np.sin(ang),
                      rng.uniform(-1.7, 5.0, m)], -1)
    return np.concatenate([fac, cross, g, poles]).astype(np.float32)


def sensor_sweep(rng, x: float, n: int, fov=SENSOR_FOV_DEG) -> np.ndarray:
    """[n, 3] points of the street canyon that a sensor at (x, 0, 0) sees
    within its vertical field of view ``fov`` (degrees; None: the whole
    sphere), in the sensor's frame."""
    parts, have = [], 0
    while have < n:
        p = street_world(rng, n) - np.array([x, 0, 0], np.float32)
        if fov is not None:
            el = np.degrees(np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1])))
            p = p[(el >= fov[0]) & (el <= fov[1])]
        parts.append(p)
        have += len(p)
    return np.concatenate(parts)[:n]


def run_slice(dev, rng, overrides=()) -> dict:
    """Phase 3: Mapper.update_model at 64x1024 on a ~100k-surfel pool."""
    from splatloam_tpu_torch.config import load_configuration
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.model.camera import make_camera
    from splatloam_tpu_torch.model.frame import Frame
    from splatloam_tpu_torch.model.local_model import LocalModel
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.preprocessing import _preprocess_device
    from splatloam_tpu_torch.profiling import get_profiler
    from splatloam_tpu_torch.slam.mapper import Mapper

    cfg = load_configuration(Path(__file__).parent / "configs" / "kitti"
                             / "kitti.yaml",
                             ["logging.enable=false", *overrides])
    pc = cfg.preprocessing
    if (pc.image_height, pc.image_width) != (H, W):
        fail("configs/kitti/kitti.yaml is no longer 64x1024")

    def frame_at(x, idx):
        pose = np.eye(4)
        pose[0, 3] = x
        pts = street_world(rng, 200_000) - np.array([x, 0, 0], np.float32)
        pts_t = torch.tensor(pts, device=dev)
        K, depth, nimg, valid = _preprocess_device(
            pts_t, torch.ones(len(pts), dtype=torch.bool, device=dev),
            pc.image_height, pc.image_width, pc.depth_min, pc.depth_max)
        return Frame(make_camera(K, depth, nimg, valid), float(idx),
                     model_T_frame=pose)

    frames = [frame_at(0.0, 0), frame_at(1.5, 1)]
    model = LocalModel(cfg, device=dev)
    seed_pts = torch.tensor(street_world(rng, N_SURFELS), device=dev)
    seed_n = -seed_pts / torch.linalg.norm(seed_pts, dim=-1, keepdim=True)
    model.surfels, model.adam = S.create_from_cloud(
        seed_pts, seed_n, capacity=1 << int(np.ceil(np.log2(N_SURFELS * 1.3))))
    mapper = Mapper(cfg, device=dev, seed=SEED)
    mapper.register_model(model)
    prof = get_profiler()
    print(f"[slice] seeded pool: {model.no_gaussians} active surfels, "
          f"capacity {model.capacity}", flush=True)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    iters, emas, updates_ms = 0, [], []
    for i, fr in enumerate(frames):
        model.insert_keyframe(fr)
        t1 = time.perf_counter()
        mapper.update_model(fr, initialize_model=(i == 0))
        torch.cuda.synchronize()
        updates_ms.append((time.perf_counter() - t1) * 1e3)
        iters += mapper.last_iters
        emas.append(float(mapper.last_ema))
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    opt_ms = prof.stats["map.optimize"].total * 1e3
    progs = mapper.programs_for(H, W, model.capacity)
    print(f"[slice] geometry {progs.params.tile_h}x{progs.params.tile_w} "
          f"chunk {progs.params.chunk} K {progs.params.tile_list_capacity} "
          f"scatter {progs.params.scatter}")
    print(f"[slice] iterations {iters}, optimize {opt_ms / iters:.3f} "
          f"ms/iteration, keyframe updates {[round(u, 1) for u in updates_ms]}"
          f" ms, total {wall:.2f} s, loss EMA {emas}, active surfels "
          f"{model.no_gaussians}, launches {launches}", flush=True)
    for k in ("K1_fwd", "K2_bwd", "K3_ranksum"):
        if launches[k] == 0:
            fail(f"{k} was not launched on the main path")
    if not all(np.isfinite(emas)):
        fail(f"loss EMA not finite: {emas}")
    for name, p in zip(S.SurfelParams._fields, model.surfels.params):
        if not bool(torch.isfinite(p[model.surfels.active]).all()):
            fail(f"non-finite {name} after the updates")

    check_rerender(mapper, frames[1], "slice")

    # the same update with each other reduction: scatter-add (the rebin-1
    # choice), fused into the backward, and the occurrence plan
    def update_with(scatter):
        cfg_m = copy.deepcopy(cfg)
        cfg_m.compute.scatter = scatter
        cfg_m.mapping.num_iterations = 31
        mapper_m = Mapper(cfg_m, device=dev, seed=SEED)
        mapper_m.register_model(model)
        kernels.reset_launch_counts()
        mapper_m.update_model(frames[1])
        torch.cuda.synchronize()
        counts = {k: v.launches for k, v in kernels.KERNELS.items()}
        ema = float(mapper_m.last_ema)
        print(f"[slice] {scatter} update: {mapper_m.last_iters} iterations, "
              f"loss EMA {ema:.5f}, launches {counts}")
        if not np.isfinite(ema):
            fail(f"{scatter} loss EMA not finite")
        return counts

    launches_rmw = update_with("rmw")
    if launches_rmw["K4_scatter_rows"] == 0:
        fail("K4_scatter_rows was not launched on the rmw path")
    launches["K4_scatter_rows"] = launches_rmw["K4_scatter_rows"]
    launches_fused = update_with("fused")
    if launches_fused["K5_bwd_fused"] == 0 or any(
            launches_fused[k] for k in ("K2_bwd", "K3_ranksum",
                                        "K4_scatter_rows")):
        fail("the fused path must launch K5 and none of K2, K3, K4")
    launches["K5_bwd_fused"] = launches_fused["K5_bwd_fused"]
    launches_plan = update_with("plan")
    if launches_plan["K2_bwd"] == 0 or \
            launches_plan["K6_scatter_overflow"] == 0:
        fail("the plan path must launch K2 and K6")
    launches["K6_scatter_overflow"] = launches_plan["K6_scatter_overflow"]
    update_multiview(cfg, model, frames)
    profile_optimize(cfg, mapper, model)
    compare_reductions(cfg, mapper, model, rng)
    launches.update(time_layouts(cfg, mapper, model))
    return launches


def run_sequence(dev, overrides=(), fov=SENSOR_FOV_DEG) -> None:
    """Phase 4: a LiDAR sequence through Preprocessor + SLAM.process with
    configs/kitti/kitti.yaml as it is (gsaligner tracking).  ``fov``: the
    sensor's vertical field of view (sensor_sweep)."""
    import tempfile

    from splatloam_tpu_torch import profiling
    from splatloam_tpu_torch.config import TrackingMethod, load_configuration
    from splatloam_tpu_torch.io.ply import load_surfel_ply
    from splatloam_tpu_torch.logging_backends import reset_datalogger
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.preprocessing import Preprocessor
    from splatloam_tpu_torch.slam import SLAM
    from splatloam_tpu_torch.slam.tracker import gauss_newton_align

    cfg = load_configuration(Path(__file__).parent / "configs" / "kitti"
                             / "kitti.yaml",
                             ["logging.enable=false", *overrides])
    tc = cfg.tracking
    if (tc.method, tc.keyframe_threshold_distance,
            tc.keyframe_threshold_fitness, cfg.compute.scatter) != \
            (TrackingMethod.gsaligner, 5.0, 0.3, "ranksum"):
        fail("configs/kitti/kitti.yaml no longer tracks with gsaligner at "
             "5 m / fitness 0.3 over the ranksum reduction")
    # the sweeps are made before the timed loop
    rng = np.random.default_rng(SEED)
    poses, clouds = [], []
    for i in range(SEQ_SWEEPS):
        pose = np.eye(4)
        pose[0, 3] = SEQ_STEP_M * i
        poses.append(pose)
        clouds.append(sensor_sweep(rng, SEQ_STEP_M * i, SEQ_POINTS, fov))

    profiling._global_profiler = profiling.Profiler()
    prof = profiling.get_profiler()
    reset_datalogger()
    pre = Preprocessor(cfg, device=dev)
    slam = SLAM(cfg, device=dev, seed=SEED)

    def timed(fn, times, k1=None):
        # synchronized host time of each call, and K1's launches in it
        def run(*a, **kw):
            torch.cuda.synchronize()
            before = kernels.KERNELS["K1_fwd"].launches
            t = time.perf_counter()
            fn(*a, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if k1 is not None:
                k1.append(kernels.KERNELS["K1_fwd"].launches - before)
        return run

    target_ms, target_k1, update_ms = [], [], []
    slam.tracker.register_keyframe = timed(slam.tracker.register_keyframe,
                                           target_ms, target_k1)
    slam.mapper.update_model = timed(slam.mapper.update_model, update_ms)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frame_ms, fitness, keyframe_frames = [], [], []
    t0 = time.perf_counter()
    for i, (cloud, pose) in enumerate(zip(clouds, poses)):
        n_kf = sum(len(m.keyframes) for m in slam.local_models)
        t1 = time.perf_counter()
        with prof.phase("preprocess"):
            frame = pre(cloud, 0.1 * i, gt_pose=pose)
        slam.process(frame)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        if i:
            fitness.append(slam.tracker.aligner.fitness())
        if sum(len(m.keyframes) for m in slam.local_models) != n_kf:
            keyframe_frames.append(i)
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    n_kf = sum(len(m.keyframes) for m in slam.local_models)
    track_ms = [ms for i, ms in enumerate(frame_ms)
                if i not in keyframe_frames]
    print(f"[slam] {SEQ_SWEEPS} sweeps of {SEQ_POINTS} points in the "
          f"vertical field of view {fov} deg, "
          f"{SEQ_STEP_M} m apart at {cfg.preprocessing.image_height}x"
          f"{cfg.preprocessing.image_width}: {SEQ_SWEEPS / wall:.3f} "
          f"frames/s over {wall:.3f} s; {len(track_ms)} frames without a "
          f"keyframe update {np.mean(track_ms):.3f} ms each "
          f"({[round(ms, 3) for ms in track_ms]})", flush=True)
    print(f"[slam] keyframes {n_kf} at frames {keyframe_frames}, submaps "
          f"{len(slam.local_models)}, active surfels "
          f"{[m.no_gaussians for m in slam.local_models]}, keyframe updates "
          f"{[round(ms, 3) for ms in update_ms]} ms, target renders "
          f"{[round(ms, 3) for ms in target_ms]} ms with K1 launches "
          f"{target_k1}", flush=True)
    print(f"[slam] fitness of frames 1-{SEQ_SWEEPS - 1} "
          f"{[round(f, 4) for f in fitness]}")
    print(f"[slam] launches over the sequence {launches}")
    print("[slam] profiler report:\n" + prof.report(), flush=True)

    gt = np.stack(poses)
    est = np.stack(slam.world_T_odom)
    t_err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    cos = (np.trace(np.einsum("nji,njk->nik", est[:, :3, :3],
                              gt[:, :3, :3]), axis1=1, axis2=2) - 1) / 2
    r_err = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    print(f"[slam] world_T_odom against GT: max translation error "
          f"{t_err.max():.4f} m (gate {TRACK_GATE_M}), max rotation error "
          f"{r_err.max():.4f} deg; per frame (x, y, z) off GT "
          f"{np.round(est[:, :3, 3] - gt[:, :3, 3], 4).tolist()}", flush=True)
    if len(est) != SEQ_SWEEPS or t_err.max() > TRACK_GATE_M:
        fail(f"tracked positions off GT by up to {t_err.max():.4f} m")
    for k in ("K1_fwd", "K2_bwd", "K3_ranksum"):
        if launches[k] == 0:
            fail(f"{k} was not launched over the sequence")
    if not target_k1 or min(target_k1) == 0:
        fail(f"K1 did not launch in every target render: {target_k1}")

    # one GN solve on the last frame, with every host synchronization an
    # error; T and the fitness are read after it
    aligner = slam.tracker.aligner
    depth, pts, normals, valid, K, h, w = aligner._target
    ap = aligner.ap
    T0 = torch.eye(4, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T, fit = gauss_newton_align(
            T0, *aligner._source, depth, pts, normals, valid, K, h, w,
            num_iterations=ap.num_iterations, huber_delta=ap.huber_delta,
            max_corr_dist=ap.max_correspondence_dist,
            inlier_threshold=ap.inlier_threshold, damping=ap.damping,
            corr_factor_init=ap.corr_factor_init,
            corr_decay_iters=ap.corr_decay_iters,
            convergence_tol=ap.convergence_tol,
            lambda_range=ap.lambda_range or 0.0)
    except RuntimeError as e:
        fail(f"gauss_newton_align synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not bool(torch.isfinite(T).all()) or not 0.0 <= float(fit) <= 1.0:
        fail("gauss_newton_align under the sync check gave no pose")
    print(f"[slam] gauss_newton_align ran {ap.num_iterations} iterations "
          f"under torch.cuda.set_sync_debug_mode('error'): no host sync, "
          f"fitness {float(fit):.4f}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        slam.cfg.output.folder = tmp
        out = slam.save_results()
        for name in ("cfg.yaml", "odom.txt", "graph.yaml"):
            if not (out / name).is_file():
                fail(f"save_results wrote no {name}")
        for i, m in enumerate(slam.local_models):
            xyz = load_surfel_ply(out / "models" / f"{i:04d}.ply")[0]
            if len(xyz) != m.no_gaussians:
                fail(f"submap {i}: {len(xyz)} surfels in its PLY, "
                     f"{m.no_gaussians} in the pool")
        print(f"[slam] save_results: cfg.yaml, odom.txt, graph.yaml and "
              f"{len(slam.local_models)} PLYs read back", flush=True)


def check_rerender(mapper, frame, tag) -> None:
    """The optimized map reproduces the keyframe's range image."""
    pkg = mapper.render_frame(frame)
    cam = frame.camera
    valid = cam.valid
    l1 = (pkg["surf_depth"] - cam.depth).abs()[valid]
    cover = float((pkg["rend_alpha"][valid] > 0.5).float().mean())
    med_l1 = float(l1.median())
    print(f"[{tag}] keyframe 1 re-render: coverage(alpha>0.5) {cover:.4f}, "
          f"median depth L1 {med_l1:.4f} m", flush=True)
    if not (cover > 0.9 and med_l1 < 0.25):
        fail(f"[{tag}] the optimized map does not reproduce the keyframe")


def update_multiview(cfg, model, frames) -> None:
    """Phase 3: one Mapper.update_model with views_per_iteration = 3 (the
    kitti.yaml settings otherwise): K1, K2 and K3 launch, and the map still
    reproduces the keyframe."""
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.slam.mapper import Mapper

    cfg_v = copy.deepcopy(cfg)
    cfg_v.mapping.views_per_iteration = 3
    mapper_v = Mapper(cfg_v, device=model.device, seed=SEED)
    mapper_v.register_model(model)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mapper_v.update_model(frames[1])
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v.launches for k, v in kernels.KERNELS.items()}
    ema = float(mapper_v.last_ema)
    print(f"[multiview] views_per_iteration 3: {mapper_v.last_iters} "
          f"iterations, keyframe update {update_ms:.1f} ms "
          f"({update_ms / mapper_v.last_iters:.3f} ms/iteration with densify "
          f"and prune), loss EMA {ema:.5f}, launches {counts}", flush=True)
    for k in ("K1_fwd", "K2_bwd", "K3_ranksum"):
        if counts[k] == 0:
            fail(f"{k} was not launched on the multi-view update")
    # one K2 launch per iteration for all views, one K3 launch per view
    if counts["K3_ranksum"] != 3 * counts["K2_bwd"]:
        fail(f"K3 ran {counts['K3_ranksum']} times for {counts['K2_bwd']} "
             "3-view backward passes")
    if not np.isfinite(ema):
        fail("multi-view loss EMA not finite")
    check_rerender(mapper_v, frames[1], "multiview")


def time_layouts(cfg, mapper, model) -> dict:
    """Phase 3: one optimize iteration's forward + backward (the mapper's
    loss on frozen tiles, host clock ending in a device sync, mean of 10)
    under the tiled and the flat layout (default budget), one view and 3
    views; then the 3-view tiled iteration under scatter "rmw" with
    scatter_tps 1 and 8.  Each pair runs in turns (A, B, B, A) against
    host drift.  Returns the launches of K7-K9 (flat runs) and K10 (the
    first tps 8 run)."""
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.ops.rasterizer import cuda_raster, kernels
    from splatloam_tpu_torch.ops.rasterizer.api import (prepare_tiles,
                                                        prepare_tiles_batch)
    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    kf = mapper._stack_keyframes(model.kf_stack["K"].shape[0])
    surf = model.surfels
    sc = torch.exp(surf.params.log_scale)
    op = torch.sigmoid(surf.params.logit_opacity) * surf.active
    dev = model.device
    views = {1: torch.tensor(1, device=dev),
             3: torch.tensor([1, 0, 1], device=dev)}

    def make_step(layout, b, **kw):
        """One iteration's forward + backward on frozen tiles, warmed up."""
        progs = MapperPrograms(cfg, H, W, model.capacity)
        progs.params = progs.params._replace(layout=layout, **kw)
        progs.views = b
        idx = views[b]
        prep = prepare_tiles if b == 1 else prepare_tiles_batch
        tiles = prep(surf.params.xyz, sc, surf.params.quat, op, kf.T_cw[idx],
                     kf.K[idx], progs.params,
                     margin_px=cfg.compute.bin_margin_px)
        loss_fn = progs._loss if b == 1 else progs._loss_multi

        def step():
            params = S.SurfelParams(*(a.detach().requires_grad_(True)
                                      for a in surf.params))
            return torch.autograd.grad(
                loss_fn(params, surf.active, kf, idx, tiles), params)

        step()
        return step, tiles

    def host_ms(step, reps=10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def in_turns(a, b):
        """(a, a) and (b, b) ms of two steps run a, b, b, a."""
        ta, tb = [host_ms(a)], [host_ms(b)]
        tb.append(host_ms(b))
        ta.append(host_ms(a))
        return ta, tb

    kernels.reset_launch_counts()
    parts = []
    for b in (1, 3):
        tiled_step, _ = make_step("tiled", b)
        flat_step, tiles = make_step("flat", b)
        t_ms, f_ms = in_turns(tiled_step, flat_step)
        n_owned = int(tiles.starts[..., -1].sum())
        parts.append(f"B={b}: tiled {t_ms[0]:.3f}/{t_ms[1]:.3f} ms, flat "
                     f"{f_ms[0]:.3f}/{f_ms[1]:.3f} ms (owned slots {n_owned} "
                     f"of budget {tiles.flat_ids.numel()}, real entries kept "
                     f"{int(tiles.counts.sum())})")
    counts = {k: v.launches for k, v in kernels.KERNELS.items()}
    base = MapperPrograms(cfg, H, W, model.capacity).params
    print(f"[flat] forward + backward per iteration at {H}x{W} "
          f"({base.tile_h}x{base.tile_w} tiles, chunk {base.chunk}, K "
          f"{base.tile_list_capacity}, scatter {base.scatter} when tiled, "
          f"default flat budget {cuda_raster._flat_capacity_for(base)} per "
          f"view), in turns tiled, flat, flat, tiled: {'; '.join(parts)}; "
          f"launches K7 {counts['K7_fwd_flat']}, K8 {counts['K8_bwd_flat']}, "
          f"K9 {counts['K9_scatter_rows_flat']}", flush=True)
    launches = {k: counts[k] for k in ("K7_fwd_flat", "K8_bwd_flat",
                                       "K9_scatter_rows_flat")}
    if not all(launches.values()):
        fail(f"a flat kernel was not launched on the flat runs: {launches}")

    tps8, _ = make_step("tiled", 3, scatter="rmw", scatter_tps=8)
    tps1, _ = make_step("tiled", 3, scatter="rmw")
    kernels.reset_launch_counts()
    t8 = [host_ms(tps8)]
    counts = {k: v.launches for k, v in kernels.KERNELS.items()}
    t1 = [host_ms(tps1), host_ms(tps1)]
    t8.append(host_ms(tps8))
    print(f"[tps] 3-view forward + backward, scatter rmw, in turns tps 8, 1, "
          f"1, 8: tps 1 {t1[0]:.3f}/{t1[1]:.3f} ms, tps 8 {t8[0]:.3f}/"
          f"{t8[1]:.3f} ms; launches on the first tps 8 run: K10 "
          f"{counts['K10_scatter_rows_tps']}, K4 {counts['K4_scatter_rows']}",
          flush=True)
    if counts["K10_scatter_rows_tps"] == 0 or counts["K4_scatter_rows"]:
        fail("scatter_tps 8 must reduce through K10 and not K4")
    launches["K10_scatter_rows_tps"] = counts["K10_scatter_rows_tps"]
    return launches


def compare_reductions(cfg, mapper, model, rng) -> None:
    """The four reductions on the same pool, keyframe and 32 Adam
    iterations: ms per iteration on the host clock, measured twice (the
    modes in order, then in reverse, against host drift), and each
    reduction's device time per iteration alone (``time_ms`` on one
    rebin's tiles: the backward with its reduction minus K2 on the same
    inputs; for "fused", K5 minus K2); on the ranksum plan also K3 alone
    and the plan's segment lengths (``confirm_k3_cause``)."""
    from splatloam_tpu_torch.ops.rasterizer import (binning, common,
                                                    cuda_raster, kernels)
    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    kf = mapper._stack_keyframes(model.kf_stack["K"].shape[0])
    surf, adam = model.surfels, model.adam
    sc = torch.exp(surf.params.log_scale)
    op = torch.sigmoid(surf.params.logit_opacity) * surf.active
    scene = (surf.params.xyz, sc, surf.params.quat, op, kf.T_cw[1], kf.K[1])
    modes = ("rmw", "ranksum", "fused", "plan")
    progs = {}
    for scatter in modes:
        cfg_m = copy.deepcopy(cfg)
        cfg_m.compute.scatter = scatter
        cfg_m.mapping.num_iterations = 31
        progs[scatter] = MapperPrograms(cfg_m, H, W, model.capacity)
    idx = torch.ones((progs["rmw"].n_blocks(),), dtype=torch.long,
                     device=model.device)
    it_ms = {m: [] for m in modes}
    for scatter in modes + modes[::-1]:
        pr = progs[scatter]
        if not it_ms[scatter]:
            pr.optimize(surf, adam, kf, idx)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pr.optimize(surf, adam, kf, idx)
        torch.cuda.synchronize()
        it_ms[scatter].append((time.perf_counter() - t0) * 1e3
                              / pr.n_iters())

    parts = []
    for scatter in modes:
        prm = progs[scatter].params
        tiles = cuda_raster.prepare_tiles(*scene, prm,
                                          margin_px=cfg.compute.bin_margin_px)
        F = binning.pack_features(common.pack_surfels(*scene)).contiguous()
        static = cuda_raster._StaticArgs(
            chunk=prm.chunk, width=W, with_median=prm.with_median,
            with_dist=prm.with_dist, fused=scatter == "fused")
        targs = (F, tiles.lists, tiles.counts, tiles.rays_t, tiles.pix_t)
        out, tb = cuda_raster._forward_tiled(*targs, static)
        g = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32),
                         device=model.device)
        plans = None if tiles.plan is None else (tiles.plan,)
        bwd_ms = time_ms(lambda: cuda_raster._backward_tiled(
            *targs, tb, out, g, static, plans))
        k2_ms = time_ms(lambda: kernels.raster_bwd(
            *targs, tb, out, g, chunk=prm.chunk, width=W,
            with_dist=prm.with_dist))
        if scatter == "ranksum":
            dFg = kernels.raster_bwd(*targs, tb, out, g, chunk=prm.chunk,
                                     width=W, with_dist=prm.with_dist)
            confirm_k3_cause(kernels, dFg.reshape(-1, 16), tiles.plan,
                             binning._ranksum_alloc(F.shape[0],
                                                    cuda_raster.RS_GROUP),
                             F.shape[0], "the mapper's plan ([compare])")
        red = "K5 - K2" if scatter == "fused" else "reduction"
        parts.append(f"{scatter} {it_ms[scatter][0]:.3f}/"
                     f"{it_ms[scatter][1]:.3f} ms/iteration, {red} "
                     f"{bwd_ms - k2_ms:.4f} ms (backward {bwd_ms:.4f}, "
                     f"K2 {k2_ms:.4f})")
    print(f"[compare] 32 iterations each on one pool: {'; '.join(parts)}",
          flush=True)


def profile_optimize(cfg, mapper, model) -> None:
    """Where an optimize iteration's time goes at the slice's shapes: the
    rebin (binning + ranksum plan) and one Adam iteration on the host
    clock, then the device time by operation and the device's idle share
    over two rebin blocks under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    cfg = copy.deepcopy(cfg)
    cfg.mapping.num_iterations = 31            # two blocks of 16
    progs = MapperPrograms(cfg, H, W, model.capacity)
    kf = mapper._stack_keyframes(model.kf_stack["K"].shape[0])
    idx = torch.ones((progs.n_blocks(),), dtype=torch.long,
                     device=model.device)
    surf, adam = model.surfels, model.adam
    sc = torch.exp(surf.params.log_scale)
    op = torch.sigmoid(surf.params.logit_opacity) * surf.active

    def rebin():
        from splatloam_tpu_torch.ops.rasterizer.api import prepare_tiles
        return prepare_tiles(surf.params.xyz, sc, surf.params.quat, op,
                             kf.T_cw[1], kf.K[1], progs.params,
                             margin_px=cfg.compute.bin_margin_px)

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, out

    rebin_ms, tiles = host_ms(rebin, 3)
    iter_ms, _ = host_ms(lambda: progs.one_iter(surf, adam, kf, idx[0],
                                                tiles), 16)
    print(f"[profile] rebin {rebin_ms:.3f} ms, one Adam iteration "
          f"{iter_ms:.3f} ms (host clock, frozen tiles)", flush=True)
    plain_ms, _ = host_ms(lambda: progs.optimize(surf, adam, kf, idx), 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        progs.optimize(surf, adam, kf, idx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    print(f"[profile] 32 iterations: wall {plain_ms:.3f} ms unprofiled, "
          f"{wall_ms:.3f} ms profiled, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}, {len(rows)} device op kinds")
    for e in rows[:15]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} x  {e.key[:90]}")


def ptxas_summary(log: str) -> str:
    """Each kernel's registers, stack frame and spill stores from nvcc's
    ``-Xptxas -v`` log, as "name<template args> regs/stack B/spill B" in
    the log's order: a stack frame without spills is a local array, which
    costs a slot-parallel body its registers' speed."""
    names = re.findall(r"Compiling entry function '(\w+)'", log)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
        names = [re.sub(r"\(splat::\(anonymous namespace\)::(\w+)\)",
                        r"\1::", "".join(m.groups("")))
                 for m in (re.search(r"(\w+)(<.*?>)?\(", n) for n in names)
                 if m]
    except (OSError, subprocess.CalledProcessError):
        pass
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                        log)
    regs = re.findall(r"Used (\d+) registers", log)
    return ", ".join(f"{n} {r}/{f}/{sp}"
                     for n, r, (f, sp) in zip(names, regs, frames))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from splatloam_tpu_torch.ops.rasterizer import kernels

    dev = torch.device("cuda")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f} s "
          f"{ {k: round(v[0], 1) for k, v in built.items()} }", flush=True)
    for source, (_, log) in built.items():
        print(f"[ptxas] {source}: {ptxas_summary(log)}", flush=True)
    rng = np.random.default_rng(SEED)
    t1 = time.perf_counter()
    results = check_kernels(dev, rng)
    t2 = time.perf_counter()
    check_render_parity(dev, rng)
    t3 = time.perf_counter()
    launches = run_slice(dev, rng)
    t4 = time.perf_counter()
    run_sequence(dev)
    t5 = time.perf_counter()
    # the host-bound phases 2 to 4 follow the host's pace, which differs
    # between machines
    print(f"[time] build {t1 - t0:.1f} s, phase 1 {t2 - t1:.1f} s, phase 2 "
          f"{t3 - t2:.1f} s, phase 3 {t4 - t3:.1f} s, phase 4 "
          f"{t5 - t4:.1f} s", flush=True)

    line = []
    for name, k in kernels.KERNELS.items():
        line.append(dict(name=name, route="cuda",
                         source=f"splatloam_tpu_torch/csrc/{k.source}",
                         replaces=k.replaces, launches=launches[name],
                         **results[name]))
    print(json.dumps({"kernels": line}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
