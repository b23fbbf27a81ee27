"""Chip smoke test of the PyTorch/CUDA port (splatloam_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from splatloam_tpu_torch/csrc, then:

  1. holds each kernel (K1 forward, K2 backward, K3 ranksum reduction,
     K4 scatter-add reduction, K5 backward fused with the scatter-add, K6
     overflow scatter-add, K7/K8/K9 forward, backward and scatter-add of
     the flat slot layout, K10 the scatter-add under scatter_tps 8, K11
     the mapper's image losses and their cotangent, at 16x256 and at the
     reconstruction cell's 128x1024 against the float64 plain version)
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
     printed for both geometries; the median's gradient (``MED``): K1's
     median slot against the plain version's (median and exit ties held
     apart) and K7's against K1's, K2, K5 and K8 under MED, given those
     slots, against their plain versions on the same slots, without and
     with the distortion term, each timed beside itself without MED.
     Kernel and index_add_ times
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
     flat) against three single-view renders, and the gradients of
     sum(final T) and sum(median) (tiled ranksum and fused, bucketed,
     flat) against the eager renderer's, the pixels whose median differs
     from the eager renderer's held apart;
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
     holding its surfels;
  5. runs the port's command line, ``[cli]``: phase 4's 12 sweeps written
     to a temporary directory in the KITTI layout (velodyne/%06d.bin as
     <f4 xyzi, times.txt at 10 Hz, calib.txt with an identity ``Tr:``,
     poses/00.txt), read back through the KITTI dataset reader (timed,
     and held to the sweeps and poses written), then ``cli.main(["slam",
     "configs/kitti/kitti-00-odom.yaml", "--device", "cuda", ...])`` in
     this process with only the data and output paths overridden (64x1024,
     gsaligner, 200 iterations), and ``cli.main(["eval_odom", ...])`` on
     its results; it fails if odom.txt does not hold 12 poses within
     0.15 m of GT, if the RPE is not finite, if K1, K2 or K3 did not
     launch in the run, or if cfg.yaml, graph.yaml and a non-empty PLY
     per submap listed in graph.yaml do not read back.  Then the same sequence under
     ``slam --supervise`` (``python -m splatloam_tpu_torch``, checkpoints
     at every keyframe, ``SPLATLOAM_FAULT_AT_FRAME``): it fails unless the
     child is restarted once, resumes past frame 0 and writes 12 poses
     within 0.15 m of GT.  Last, the committed VBR bag
     (tests/fixtures/vbr_seq.bag: ROS1, LZ4 chunks, ouster PointCloud2)
     through the VBR reader at tests/test_cli_vendor.py's 16x256
     configuration and gates.  It prints ``native.available()``, the
     reader's ms per sweep, frames/s over the command's wall time, and,
     from the command's own phase profile, ms per frame without a
     keyframe update and ms per keyframe update, and each run's wall
     time;
  6. meshes, ``[mesh]``: ``cli.main(["mesh", <phase 5's results>,
     "--device", "cuda", ...])`` with the TSDF, then the grid Poisson
     method, and ``eval_recon`` of each mesh against the street canyon's
     world cloud (600,000 points, seed 0) with tools/recon_parity.py's
     protocol (2 cm downsample, F-score at 0.2 m, truncation 0.5 m,
     2,000,000 mesh samples); it prints K1's launches in each ``mesh``
     run, the ms of each keyframe render, the fusion's and the
     triangulation's time from the command's phase profile, and
     eval_recon's wall time and metrics, and fails if a mesh is empty or
     not finite, if K1 did not launch in a ``mesh`` run or if a metric is
     not finite;
  7. multi-device mapping, ``[parallel]``, on the one card, from phase
     3's pool with kitti.yaml's geometry at a tile-list capacity no tile
     fills (found from the data): (a) the "tiles" partition on a 1x1
     mesh over NCCL in this process; (b) 4 gloo ranks sharing cuda:0
     (this script with ``--parallel-rank``; the parent built the
     kernels, the ranks only load them), "tiles" and "rows" at (2,2) and
     "ring" at (1,4): one iteration's gradient on keyframe 1 against the
     single render's (the ring's against the same depth bands rendered
     and folded on one device, and against the single render on the
     surfels that see the same slots in both) at 2e-3 x max|g|, a
     32-iteration update against the single-device one within 3x the
     float-order spread of the four reductions (99th percentile per
     field; the ring's against the band fold's, within 3x the spread of
     both programs' reductions, pooled, paired by position) and
     check_rerender's
     gates, K1/K2/K3 launched on every rank, the counted send bytes per
     iteration against the JAX package's formula, the ring's forward
     against the single render by tile class (its early-exit bound where
     a tile exits); (c) ``slam`` of phase 5's sweeps under ``python -m
     torch.distributed.run --nproc-per-node 4`` with parallel.data=2
     parallel.model=2: 12 poses within 0.15 m of GT and one results
     folder.  Ranks that share one card measure correctness, not
     scaling;
  8. the reconstruction configuration, ``[recon]``:
     configs/ncd/quad-easy-mapping-gt.yaml as shipped (128x1024, GT
     poses, 500 iterations an update, densify 0.4, a keyframe every 6
     frames, 30-keyframe submaps, uniform replay, the active scale
     penalty) on 25 sweeps of the street canyon cast by an OS0-128-like
     sensor (128 beams over -45 to +45 degrees, 1024 steps, one return
     per beam and step; 0.1 m apart), written in the KITTI layout and run
     through ``cli.main(["slam", ...])`` with only the data section and
     the output folder overridden, then ``mesh`` (TSDF, 0.15 m voxels)
     and ``eval_recon`` against the world cloud (phase 6's protocol); it
     prints frames/s, ms per update and per optimize iteration, the
     pool's capacity at each update, the tiles whose list reached K at
     each update's first rebin, the wide splats beyond the binner's
     budgets and the (tile, splat) pairs they cost, peak device memory,
     K1/K2/K3 launches over slam + mesh, mesh's steps and eval_recon's
     metrics, and fails unless the command returns, odom.txt holds the
     GT poses within 1e-5 m, K2 = K3 = the iterations run and K1 covers
     them, the densify renders and mesh's renders, every keyframe
     re-renders (coverage > 0.9, median depth L1 < 0.25 m), the pool
     reaches 131,072 rows, the mesh's accuracy is below
     RECON_ACC_LIMIT_CM, and K1, K2 + K3's gradient hold to their plain
     versions on the last pool at 2048 tiles (timed beside their
     bounds);
  9. the compiled programs, ``[graphs]``: on phase 3's pool
     (kitti.yaml, 64x1024, 300 iterations at rebin 16) the update under
     "ranksum", "rmw", "fused", "plan" and with 3 views per iteration,
     uncaptured twice and captured twice (the first with its capture,
     the second replaying from block 0 on freshly loaded buffers); it
     fails unless each captured update holds to the uncaptured ones
     field by field (``spread_gate``: bitwise where the uncaptured runs
     agree, within their spread where atomics part them), each kernel's
     launches are equal on both paths and one block replays under
     ``torch.cuda.set_sync_debug_mode("error")``; it prints ms per
     iteration of both paths, two blocks of each under torch.profiler
     (device busy, idle share), a GN solve on phase 4's last frame
     captured against uncaptured (ms per solve of both), each graph's
     captures, replays and memory, and the peak device memory.  Phases
     3-5 and 8 run captured, as the entry points do on CUDA; phase 7's
     sharded programs run uncaptured.

It imports nothing of JAX.  It prints one line per kernel check, the
kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failed check exits non-zero.
"""
from __future__ import annotations

import copy
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
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


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


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


def fwd_bwd_bounds(args, out, tb, g, n_real: int, chunk: int):
    """K1's and K2's bounds from this run's data on K1's arguments
    ``args``, outputs ``out``, ``tb`` and cotangents ``g``: the pairs are
    the slots each tile composited (up to its exit at T_EPS) times its
    pixels; K2 also writes the rows of the ``n_real`` real slots.
    -> (pairs, composited slots, K1's (ms, by), K2's (ms, by))."""
    from splatloam_tpu_torch.ops.rasterizer.common import T_EPS
    counts, rays = args[2], args[3]
    n_live = ((tb > T_EPS).any(dim=1)).sum(dim=1)
    slots = float(torch.minimum(counts.long(), n_live * chunk).sum())
    pairs = slots * rays.shape[1]
    return (pairs, slots,
            bound(nbytes(*args, out, tb), pairs * FWD_OPS_PER_PAIR),
            bound(nbytes(*args, tb, out, g) + n_real * 64,
                  pairs * BWD_OPS_PER_PAIR))


def k3_bound(plan, r_alloc: int):
    """K3's bound over a ranksum plan's real entries (the padding id's
    skipped): each reads its row and plan entries once, and the whole
    accumulator (zero-filled) is written once.  -> (the real entries
    [E] bool, their count, (ms, by))."""
    real3 = (plan.ranks >= 0) & (plan.ranks != plan.rank_of_id[-1])
    n_real3 = int(real3.sum())
    return real3, n_real3, bound(n_real3 * (64 + 4 + 4) + r_alloc * 64,
                                 n_real3 * 16)


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
        pairs, slots, (b1, by1), (b2, by2) = fwd_bwd_bounds(
            args, out, tb, g, int(real.sum()), params.chunk)
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
        real3, n_real3, (b3, by3) = k3_bound(plan, r_alloc)
        rank_real = plan.ranks[real3].long()
        rows_real3 = rows[plan.pos[real3].long()]
        lib3 = time_ms(lambda: rows.new_zeros((r_alloc, 16)).index_add_(
            0, rank_real, rows_real3))
        report("K3_ranksum[main]", err3, tol34, ms3, pms3, lib3)
        confirm_k3_cause(kernels, rows, plan, r_alloc, n_rows)
        E = plan.pos.numel()
        # the earlier bound read every entry's row, the pad segment's
        # included
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
            n_rows, slots, pairs, RS_GROUP * RS_GPS))
        results.update(check_flat_and_tps(
            kernels, cuda_raster, scene, params, tiles, F, (out, tb), g, dFg,
            dF4, pairs, results["K4_scatter_rows"]))
        time_bwd_with_dist(kernels, params, tiles, F, fwd_dist, g, n_rows)
        check_med_kernels(kernels, args, params.chunk, g, n_rows)
        check_rows_past_count(kernels, binning, cuda_raster, tiles, dFg,
                              n_rows, RS_GROUP * RS_GPS)
        check_bucketed(dev, kernels, binning, cuda_raster, scene, params, F,
                       n_rows)
        check_scatter_adversarial(dev, kernels, cuda_raster, tiles, n_rows)
        check_tiles_adversarial(dev, kernels, binning, common, scene, tiles,
                                params.chunk)
    results["K11_image_loss"] = check_image_loss(
        dev, kernels, np.random.default_rng(SEED + 11))
    return results


def image_loss_inputs(rng, b: int, h: int, w: int, dev, tile=(4, 16)):
    """K11's arguments for ``b`` synthetic views in the tiled layout: a
    smooth range image rendered with alpha in (0, 1), a block of alpha 0
    and of zero depth (degenerate normals), invalid pixels; K fitted to
    +-45 degrees.  -> (out, depth, valid, K, T_cw)."""
    from splatloam_tpu_torch.geometry import se3
    from splatloam_tpu_torch.ops.rasterizer import binning
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    outs, depths, valids = [], [], []
    for _ in range(b):
        gt = 8.0 + 3.0 * np.sin(u * 6 * np.pi / w) + 4.0 * v / h
        sd = gt + rng.normal(scale=0.05, size=gt.shape)
        alpha = rng.uniform(0.05, 0.999, size=gt.shape)
        alpha[2:6, 5:10] = 0.0
        dsum = alpha * sd
        dsum[8:12, 20:26] = 0.0
        n = rng.normal(size=(h, w, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        ch = np.concatenate([dsum[..., None], alpha[..., None],
                             alpha[..., None] * n,
                             (sd + rng.normal(scale=0.05, size=gt.shape))
                             [..., None], np.zeros((h, w, 1)),
                             (1.0 - alpha)[..., None]], -1)
        outs.append(binning.tile_image(
            torch.tensor(ch, dtype=torch.float32), *tile))
        depths.append(torch.tensor(gt, dtype=torch.float32))
        valids.append(torch.tensor(rng.uniform(size=gt.shape) < 0.85))
    fy = -(h - 1) / np.radians(90.0)
    K = torch.tensor([[w / (2 * np.pi), 0.0, w / 2.0 - 1.0],
                      [0.0, fy, -0.5 - fy * np.radians(45.0)],
                      [0.0, 0.0, 1.0]], dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(b, 4)), dtype=torch.float32)
    T_cw = torch.eye(4).repeat(b, 1, 1)
    T_cw[:, :3, :3] = se3.quat_to_rotmat(q / q.norm(dim=-1, keepdim=True))
    return tuple(x.to(dev) for x in (torch.cat(outs), torch.stack(depths),
                                     torch.stack(valids),
                                     K[None].repeat(b, 1, 1), T_cw))


def hold_image_loss(name, kernels, args, kw) -> tuple[float, float]:
    """K11 on ``args`` against its plain version in float64 (the loss to
    1e-5 relative, g to 1e-4 of its largest entry over the pixels that
    are not depth-L1 ties: the float32 plain version's own error is
    printed beside), and run twice for the same bits.  -> (g's error over
    its largest entry, the loss's relative error)."""
    loss, g = kernels.image_loss(*args, **kw)
    loss2, g2 = kernels.image_loss(*args, **kw)
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    loss64, g64 = kernels.image_loss_plain(*f64, **kw)
    loss32, g32 = kernels.image_loss_plain(*args, **kw)
    ties = kernels.image_loss_ties(*args[:3], **kw)[..., None]
    torch.cuda.synchronize()
    gmax = float(g64.abs().max())

    def err_of(x):
        return float(torch.where(ties, 0.0, (x.double() - g64).abs()).max()
                     ) / gmax

    err, err32 = err_of(g), err_of(g32)
    lerr = float(((loss.double() - loss64).abs() / loss64.abs()).max())
    lerr32 = float(((loss32.double() - loss64).abs() / loss64.abs()).max())
    print(f"[kernel] {name} vs the float64 plain version: g {err:.3e} of "
          f"its largest (tol 1e-4; float32 plain version {err32:.3e}; "
          f"{int(ties.sum())} depth-L1 ties of {ties.numel()} pixels held "
          f"apart), loss {lerr:.3e} relative (tol 1e-5; float32 plain "
          f"version {lerr32:.3e})", flush=True)
    if not (err <= 1e-4 and lerr <= 1e-5):
        fail(f"{name} disagrees with its plain version: g {err}, loss {lerr}")
    if not (torch.equal(loss, loss2) and torch.equal(g, g2)):
        fail(f"{name} is not deterministic")
    return err, lerr


def image_loss_bound(args) -> tuple[float, str]:
    """K11's bound: out, the keyframes' depth and mask and K read once,
    g and the loss written once."""
    out = args[0]
    return bound(nbytes(*args[:4]) + nbytes(out) + 4 * args[1].shape[0],
                 0.0)


def check_image_loss(dev, kernels, rng) -> dict:
    """K11 against its plain version at 16x256 (one and 3 views) and at
    the reconstruction cell's 128x1024 (2048 tiles of 64 px, one view),
    with and without the median; timed at 128x1024 beside the plain
    version."""
    kw = dict(tile_h=4, tile_w=16, lambda_normal=0.1, lambda_alpha=0.05)
    for b, h, w in ((1, 16, 256), (3, 16, 256), (1, 128, 1024)):
        args = image_loss_inputs(rng, b, h, w, dev)
        for ratio in (0.0, 0.5):
            err, _ = hold_image_loss(f"K11_image_loss[{b}x{h}x{w}, "
                                     f"depth_ratio {ratio}]", kernels, args,
                                     dict(kw, depth_ratio=ratio))
    kw["depth_ratio"] = 0.0
    ms = time_ms(lambda: kernels.image_loss(*args, **kw))
    pms = event_ms(lambda: kernels.image_loss_plain(*args, **kw), 5)
    b_ms, by = image_loss_bound(args)
    report("K11_image_loss[128x1024]", err, 1e-4, ms, pms)
    print(f"[kernel] K11 at 128x1024 (2048 tiles x 64 px, one view): "
          f"{ms:.4f} ms, bound {b_ms:.4f} ms ({by}), plain version "
          f"{pms:.4f} ms; torch.profiler "
          f"{profile_ms(lambda: kernels.image_loss(*args, **kw))}",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=by, library_ms=None)


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


def check_med_kernels(kernels, args, chunk: int, g, n_rows: int) -> None:
    """Phase 1: the median's gradient at the main path's shapes, without
    and with the distortion term.  K1's median slot against the plain
    version's (pixels in ``median_ties`` and tiles in ``exit_ties``, from
    the float64 plain version, held apart) and K7's over the same slots as
    a flat layout against K1's (one body: equal); then K2, K5 and K8 under
    MED, given K1's (K7's) slots, against their plain versions on the same
    slots at 2e-3 of the largest row entry (K2's tolerance), and each
    kernel under MED timed beside itself without it."""
    F, lists, counts, rays, pix = args
    real = (torch.arange(lists.shape[1], device=lists.device)[None, :]
            < counts[:, None])
    for dist in (False, True):
        kw = dict(chunk=chunk, width=W, with_median=True, with_dist=dist)
        out, tb, slot = kernels.raster_fwd(*args, return_slot=True, **kw)
        _, _, slot_p = kernels.raster_fwd_plain(*args, return_slot=True,
                                                **kw)
        out64, tb64 = kernels.raster_fwd_plain(
            *(a.double() if a.is_floating_point() else a for a in args),
            **kw)
        tie = median_ties(kernels, args, tb64, chunk)
        xtie = exit_ties(kernels, counts, out64, tb64, chunk)
        keep = ~tie & ~xtie[:, None]
        n_bad = int(((slot != slot_p) & keep).sum())
        n_med = int((slot >= 0).sum())
        ids, starts, tbf = flat_of_tiles(lists, counts, tb, chunk,
                                         n_rows - 1)[:3]
        out7, tbf7, slot7 = kernels.raster_fwd_flat(
            F, ids, starts, rays, pix, return_slot=True, **kw)
        n7 = int((slot7 != slot).sum())
        ms1 = time_ms(lambda: kernels.raster_fwd(*args, **kw))
        print(f"[kernel] K1 median slot (dist {int(dist)}): {n_med} pixels "
              f"with a median, {n_bad} differ from the plain version's "
              f"outside {int((~keep).sum())} held apart (median and exit "
              f"ties); K7's differ from K1's at {n7} pixels; K1 "
              f"{ms1:.4f} ms", flush=True)
        if n_bad or n7 or n_med == 0:
            fail(f"the median slot (dist {int(dist)}): {n_bad} pixels off "
                 f"the plain version's, K7 off K1's at {n7}, {n_med} "
                 "medians")
        bkw = dict(chunk=chunk, width=W, with_dist=dist)
        bargs = (*args, tb, out, g)
        args8 = (F, ids, starts, rays, pix, tbf7, out7, g)
        n_own = int(starts[0, -1])
        errs, ms = [], []
        for name, run, plain, sel in (
                ("K2", lambda m: kernels.raster_bwd(*bargs, med_slot=m,
                                                    **bkw),
                 lambda m: kernels.raster_bwd_plain(*bargs, med_slot=m,
                                                    **bkw),
                 lambda r: r[real]),
                ("K5", lambda m: kernels.raster_bwd_fused(
                    *bargs, n_rows, med_slot=m, **bkw),
                 lambda m: kernels.raster_bwd_fused_plain(
                     *bargs, n_rows, med_slot=m, **bkw),
                 lambda r: r),
                ("K8", lambda m: kernels.raster_bwd_flat(
                    *args8, med_slot=m, **bkw),
                 lambda m: kernels.raster_bwd_flat_plain(
                     *args8, med_slot=m, **bkw),
                 lambda r: r[:n_own])):
            m = slot7 if name == "K8" else slot
            got, want = sel(run(m)), sel(plain(m))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 2e-3 * float(want.abs().max())
            # the median term is there: the rows move with it
            moved = float((want - sel(plain(None))).abs().max())
            errs.append(f"{name} {err:.3e} (tol {tol:.3e}, the median "
                        f"term moves rows by {moved:.3e})")
            if not (err <= tol and moved > tol):
                fail(f"{name} under MED (dist {int(dist)}): {err} > {tol} "
                     f"against the plain version, or the median term "
                     f"moved nothing ({moved})")
            ms.append((name, time_ms(lambda: run(m)),
                       time_ms(lambda: run(None))))
        print(f"[kernel] backward under MED (dist {int(dist)}) vs the plain "
              f"version on the same slots: {'; '.join(errs)}", flush=True)
        print(f"[kernel] MED timing (dist {int(dist)}, graph replay, ms "
              f"with / without MED): "
              + ", ".join(f"{n} {a:.4f} / {b:.4f}" for n, a, b in ms),
              flush=True)


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
        out, tb, _ = cuda_raster._forward_tiled(*args, static)
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
    check_channel_gradients(scene, params, n_tiles, ref["median"].detach())


def check_channel_gradients(scene, params, n_tiles, med_ref) -> None:
    """Phase 2: the gradients of sum(final_T) and sum(median) through
    ``rasterize`` on the cuda backend (tiled ranksum and fused, bucketed,
    flat) against the eager renderer, at the tests' tolerances (2e-3 x
    max|g|, pose 3e-3).  A pixel whose median differs from the eager
    renderer's by more than 1e-4 (a slot chosen apart at T = 0.5) is held
    apart: both renders' median losses weigh it 0."""
    from splatloam_tpu_torch.ops.rasterizer.api import rasterize
    from splatloam_tpu_torch.ops.rasterizer.eager_ref import rasterize_eager

    h, w = params.height, params.width
    names = ["xyz", "scales", "quat", "opacity", "T_cw"]
    flat = dict(layout="flat", flat_capacity=n_tiles
                * params.tile_list_capacity)
    for label, kw in [("ranksum", {}), ("fused", dict(scatter="fused")),
                      ("bucketed-fused", dict(layout="bucketed",
                                              scatter="fused",
                                              bucket_frac=0.75)),
                      ("flat", flat)]:
        p = params._replace(**kw)
        leaves = [a.clone().requires_grad_(True) for a in scene[:5]]
        out = rasterize(*leaves, scene[5], p)
        keep = ((out["median"].detach() - med_ref).abs() <= 1e-4).float()
        for channel, loss in (
                ("final_T", lambda c: c["final_T"].sum()),
                ("median", lambda c: (c["median"] * keep).sum())):
            g_k = torch.autograd.grad(loss(out), leaves, retain_graph=True)
            leaves_r = [a.clone().requires_grad_(True) for a in scene[:5]]
            g_r = torch.autograd.grad(
                loss(rasterize_eager(*leaves_r, scene[5], h, w)), leaves_r,
                allow_unused=True)
            errs = []
            for name, a, b, rel in zip(names, g_k, g_r, [2e-3] * 4 + [3e-3]):
                b = torch.zeros_like(a) if b is None else b
                tol = rel * float(b.abs().max()) + 1e-6
                err = float((a - b).abs().max())
                errs.append(f"{name} {err:.2e}/{tol:.2e}")
                if not err <= tol:
                    fail(f"{label}: the gradient of sum({channel}) for "
                         f"{name} is {err} off the eager renderer's "
                         f"(tol {tol})")
            held = f", {int((keep == 0).sum())} median pixels held apart" \
                if channel == "median" else ""
            print(f"[parity] grad of sum({channel}) {label} vs eager "
                  f"(err/tol): {', '.join(errs)}{held}", flush=True)


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


def sensor_raster(rng, x: float, h: int, w: int, fov) -> np.ndarray:
    """[<= h*w, 3] returns of a spinning LiDAR at (x, 0, 0) in the street
    canyon, in the sensor's frame: h beams spread evenly over the vertical
    field of view ``fov`` (degrees) and w azimuth steps, each ray
    jittered within its cell and cast against street_world's surfaces
    (facades, cross walls, ground, poles); a ray that hits nothing (the
    sky) returns no point.  One return per beam and step, as an Ouster
    sensor gives, where ``sensor_sweep`` draws the world's points."""
    lo, hi = np.radians(fov[0]), np.radians(fov[1])
    el = hi - (np.arange(h)[:, None] + rng.uniform(0, 1, (h, w))) \
        * (hi - lo) / h
    az = -np.pi + (np.arange(w)[None, :] + rng.uniform(0, 1, (h, w))) \
        * 2 * np.pi / w
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).reshape(-1, 3)
    o = np.array([x, 0.0, 0.0])
    best = np.full(len(d), np.inf)

    def keep(t, ok):
        np.minimum(best, np.where(ok & (t > 0), t, np.inf), out=best)

    with np.errstate(divide="ignore", invalid="ignore"):
        for axis, level, (a1, lo1, hi1), (a2, lo2, hi2) in (
                (1, -9.0, (0, -60, 60), (2, -1.7, 8.0)),     # facades
                (1, 11.0, (0, -60, 60), (2, -1.7, 8.0)),
                (0, -55.0, (1, -9, 11), (2, -1.7, 8.0)),     # cross walls
                (0, 58.0, (1, -9, 11), (2, -1.7, 8.0)),
                (2, -1.7, (0, -60, 60), (1, -9, 11))):       # ground
            t = (level - o[axis]) / d[:, axis]
            p = o + t[:, None] * d
            keep(t, (p[:, a1] >= lo1) & (p[:, a1] <= hi1)
                 & (p[:, a2] >= lo2) & (p[:, a2] <= hi2))
        for cx in (-30.0, -10.0, 15.0, 35.0):                # poles
            q = o[:2] - np.array([cx, 7.0])
            a = (d[:, :2] ** 2).sum(-1)
            b = 2 * (d[:, :2] @ q)
            disc = b * b - 4 * a * ((q ** 2).sum() - 0.3 ** 2)
            t = (-b - np.sqrt(disc)) / (2 * a)
            z = t * d[:, 2]
            keep(t, (disc >= 0) & (z >= -1.7) & (z <= 5.0))
    hit = np.isfinite(best)
    return (best[hit, None] * d[hit]).astype(np.float32)


def run_slice(dev, rng, overrides=()):
    """Phase 3: Mapper.update_model at 64x1024 on a ~100k-surfel pool.
    Returns (the launch counts, (cfg, mapper, model, frames)) for phase
    7."""
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
    if launches["K11_image_loss"] != iters:
        fail(f"K11 launched {launches['K11_image_loss']} times for {iters} "
             "iterations")
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
    return launches, (cfg, mapper, model, frames)


def run_sequence(dev, overrides=(), fov=SENSOR_FOV_DEG):
    """Phase 4: a LiDAR sequence through Preprocessor + SLAM.process with
    configs/kitti/kitti.yaml as it is (gsaligner tracking).  ``fov``: the
    sensor's vertical field of view (sensor_sweep).  Returns (GT poses,
    sweeps, frames/s, the SLAM)."""
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

    profiling.reset_profiler()
    prof = profiling.get_profiler()
    reset_datalogger()
    pre = Preprocessor(cfg, device=dev)
    slam = SLAM(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

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
    print(f"[slam] captured graphs (the entry points capture on CUDA): "
          f"mapper blocks {graph_stats_line(slam.mapper.graph_stats())}; "
          f"GN solves {graph_stats_line(slam.tracker.aligner.graph_stats())}"
          f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
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
    return poses, clouds, SEQ_SWEEPS / wall, slam


# ---------------------------------------------------------------------------
# phase 5: the command line
# ---------------------------------------------------------------------------

ODOM_CFG = "configs/kitti/kitti-00-odom.yaml"
# the first checkpoint is written while the first keyframe after frame 0
# is processed (frame 6 of these sweeps): the fault comes after it, so
# the restarted child resumes past frame 0
FAULT_AT_FRAME = 8
VBR_CFG = """
data:
  dataset_type: vbr
  cloud_reader:
    cloud_folder: {bag}
preprocessing:
  image_height: 16
  image_width: 256
  depth_min: 0.8
  depth_max: 45.0
  enable_normal_estimation: false
  enable_ground_segmentation: false
mapping:
  num_iterations: 15
  densify_percentage: 0.5
  lmodel_threshold_ngaussians: 30000
tracking:
  keyframe_threshold_nframes: 2
  keyframe_threshold_distance: -1
  keyframe_threshold_fitness: -1
compute:
  initial_capacity: 2048
  keyframe_capacity: 8
logging:
  enable: false
output:
  folder: {out}
  writer: tum
"""


def write_kitti_layout(root: Path, poses, clouds) -> tuple[Path, Path]:
    """The sweeps in the KITTI odometry layout: sequences/00/velodyne/
    %06d.bin (<f4 x y z intensity), times.txt (10 Hz), calib.txt (an
    identity Tr:) and poses/00.txt (3x4 row-major GT poses)."""
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    for i, cloud in enumerate(clouds):
        xyzi = np.concatenate([cloud, np.zeros((len(cloud), 1), np.float32)],
                              axis=1)
        xyzi.astype("<f4").tofile(seq / "velodyne" / f"{i:06d}.bin")
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6f}\n"
                                           for i in range(len(clouds))))
    (seq / "calib.txt").write_text("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    gt = root / "poses" / "00.txt"
    gt.parent.mkdir()
    gt.write_text("".join(" ".join(f"{v:.9f}" for v in T[:3].reshape(-1))
                          + "\n" for T in poses))
    return seq, gt


def odom_error(odom_file: Path, poses) -> np.ndarray:
    """Per-frame translation error of a KITTI-format odom.txt against GT."""
    est = np.loadtxt(odom_file).reshape(-1, 3, 4)
    if len(est) != len(poses):
        fail(f"{odom_file} holds {len(est)} poses, not {len(poses)}")
    return np.linalg.norm(est[:, :, 3] - np.stack(poses)[:, :3, 3], axis=-1)


def only_dir(folder: Path) -> Path:
    dirs = sorted(folder.iterdir())
    if len(dirs) != 1:
        fail(f"{folder}: {len(dirs)} result folders, expected 1")
    return dirs[0]


def run_in_group(argv, env, timeout_s: float) -> tuple[int, str]:
    """Run a command in its own process group (the supervisor and its
    children); on timeout kill the whole group.  -> (rc, stdout+stderr)."""
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{argv[:5]} did not finish within {timeout_s} s")
    return proc.returncode, out


def run_cli(dev, poses, clouds, inproc_fps: float, tmp: Path):
    """Phase 5: the sequence of phase 4 through the port's command line
    on ``dev``, in the directory ``tmp``.  Returns the results directory
    of its first run, its data arguments and its frames/s."""
    from splatloam_tpu_torch import cli
    from splatloam_tpu_torch.config import load_configuration
    from splatloam_tpu_torch.io import native
    from splatloam_tpu_torch.io.datasets import get_dataset_reader
    from splatloam_tpu_torch.io.ply import load_surfel_ply
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.postprocessing import ResultGraph
    from splatloam_tpu_torch.profiling import get_profiler

    root = Path(__file__).resolve().parent
    os.chdir(root)      # the config names its parent relative to the root
    print(f"[cli] native.available() = {native.available()}", flush=True)
    seq, gt = write_kitti_layout(tmp, poses, clouds)
    data = [f"data.cloud_reader.cloud_folder={seq}",
            f"data.trajectory_reader.filename={gt}"]

    # the dataset reader alone: every sweep and pose as written
    reader = get_dataset_reader(load_configuration(ODOM_CFG, data))
    t = time.perf_counter()
    triples = list(reader)
    read_ms = (time.perf_counter() - t) * 1e3 / len(triples)
    if len(triples) != len(clouds) or any(
            not np.array_equal(c, cloud) or not np.allclose(T, pose)
            or abs(ts - 0.1 * i) > 1e-9
            for i, ((c, ts, T), cloud, pose) in
            enumerate(zip(triples, clouds, poses))):
        fail("the KITTI reader did not give back the sweeps, stamps "
             "and poses written")
    print(f"[cli] KITTI reader: {len(triples)} sweeps of {len(clouds[0])} "
          f"points, {read_ms:.3f} ms per sweep (one-file prefetch "
          f"thread)", flush=True)

    # run 1: slam in this process; its frames are timed by the
    # command's own phase profile (each frame's "process" phase ends
    # on the tracked pose, read back to the host; each "map_update"
    # ends on the pruned count)
    out1 = tmp / "run1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    cli.main(["slam", ODOM_CFG, "--device", dev.type, *data,
              f"output.folder={out1}"])
    wall1 = time.perf_counter() - t
    peak1 = torch.cuda.max_memory_allocated()
    launches = {k: v.launches for k, v in kernels.KERNELS.items()
                if v.launches}
    stats = get_profiler().stats
    frame_s = [a + b for a, b in zip(stats["preprocess"].samples,
                                     stats["process"].samples)]
    update_ms = [1e3 * s for s in stats["map_update"].samples]
    n = len(frame_s)
    rdir = only_dir(out1)
    graph = ResultGraph.from_yaml(rdir / "graph.yaml")
    kf_frames = sorted(round(f.timestamp / 0.1) for f in graph.frames)
    plain = [1e3 * s for i, s in enumerate(frame_s)
             if i not in kf_frames]
    if n != len(clouds) or len(update_ms) != len(kf_frames):
        fail(f"the phase profile holds {n} frames and {len(update_ms)} "
             f"map updates, not {len(clouds)} and {len(kf_frames)}")
    print(f"[cli] slam {ODOM_CFG} --device {dev.type}: {n} frames, "
          f"{n / wall1:.3f} frames/s over the command's {wall1:.3f} s "
          f"(its frame loop {sum(frame_s):.3f} s); phase 4 ran "
          f"kitti.yaml, another configuration: {inproc_fps:.3f}",
          flush=True)
    print(f"[cli] keyframes at frames {kf_frames} (frame 0 opens the "
          f"map); {len(plain)} frames without a keyframe update "
          f"{np.mean(plain):.3f} ms each "
          f"({[round(ms, 3) for ms in plain]}); keyframe updates "
          f"{[round(ms, 3) for ms in update_ms]} ms", flush=True)
    print(f"[cli] launches over the run {launches}", flush=True)
    for k in ("K1_fwd", "K2_bwd", "K3_ranksum"):
        if not launches.get(k):
            fail(f"{k} was not launched in the CLI's run")
    rdir = only_dir(out1)
    err = odom_error(rdir / "odom.txt", poses)
    print(f"[cli] odom.txt against GT: max translation error "
          f"{err.max():.4f} m (gate {TRACK_GATE_M}); per frame "
          f"{np.round(err, 4).tolist()}", flush=True)
    if err.max() > TRACK_GATE_M:
        fail(f"the CLI's odometry is off GT by up to {err.max():.4f} m")
    cfg_back = load_configuration(rdir / "cfg.yaml")
    if (cfg_back.mapping.num_iterations,
            cfg_back.preprocessing.image_width) != (200, W):
        fail("cfg.yaml does not hold kitti-00-odom.yaml's settings")
    plys = sorted((rdir / "models").glob("*.ply"))
    if [Path(m.filename).name for m in graph.models] != \
            [p.name for p in plys]:
        fail(f"graph.yaml's submaps {[m.filename for m in graph.models]}"
             f" are not the PLYs written {[p.name for p in plys]}")
    surfels = [load_surfel_ply(p)[0] for p in plys]
    if any(len(xyz) == 0 or not np.isfinite(xyz).all()
           for xyz in surfels):
        fail("a submap's PLY is empty or holds non-finite positions")
    t = time.perf_counter()
    cli.main(["eval_odom", str(rdir)])
    eval_s = time.perf_counter() - t
    with open(rdir / "evaluation_rpe.csv") as f:
        rpe = dict(zip(*[line.strip().split(",") for line in f]))
    rpe_mean = float(rpe["rpe-mean"])
    print(f"[cli] eval_odom: RPE {rpe_mean} +- {float(rpe['rpe-stdev'])}"
          f" in {eval_s:.3f} s; cfg.yaml, graph.yaml and "
          f"{len(plys)} PLYs read back, surfels "
          f"{[len(xyz) for xyz in surfels]}", flush=True)
    if not np.isfinite(rpe_mean):
        fail("eval_odom gave a non-finite RPE")

    # run 2: supervised, one injected fault, resumed from a checkpoint
    if not any(0 < k < FAULT_AT_FRAME for k in kf_frames):
        fail(f"no keyframe between frame 0 and frame {FAULT_AT_FRAME}: "
             "the fault would come before the first checkpoint")
    ckpt = tmp / "ckpt"
    env = dict(os.environ, SPLATLOAM_FAULT_AT_FRAME=str(FAULT_AT_FRAME))
    t = time.perf_counter()
    rc, log = run_in_group(
        [sys.executable, "-m", "splatloam_tpu_torch", "slam", ODOM_CFG,
         "--supervise", "--device", dev.type, *data,
         f"output.folder={tmp / 'run2'}",
         f"output.checkpoint_dir={ckpt}",
         "output.checkpoint_every_keyframes=1"], env, 900)
    wall2 = time.perf_counter() - t
    flat = re.sub(r"\s+", " ", log)
    starts = [int(k) for k in re.findall(
        r"attempt \d+ \(checkpoint at frame (\d+)", flat)]
    print(f"[cli] slam --supervise, fault at frame {FAULT_AT_FRAME}: "
          f"rc {rc}, attempts starting at checkpoint frames {starts}, "
          f"{wall2:.3f} s", flush=True)
    if rc != 0 or len(starts) != 2 or starts[1] == 0 or \
            not (ckpt / ".fault_injected").exists():
        print(log[-6000:])
        fail("the supervised run did not restart once from a "
             "checkpoint past frame 0")
    err2 = odom_error(only_dir(tmp / "run2") / "odom.txt", poses)
    print(f"[cli] supervised odom.txt: max translation error "
          f"{err2.max():.4f} m", flush=True)
    if err2.max() > TRACK_GATE_M:
        fail(f"the resumed run is off GT by up to {err2.max():.4f} m")

    # run 3: the committed VBR bag, tests/test_cli_vendor.py's gates
    vcfg = tmp / "vbr.yaml"
    vcfg.write_text(VBR_CFG.format(
        bag=root / "tests" / "fixtures" / "vbr_seq.bag",
        out=tmp / "run3"))
    t = time.perf_counter()
    cli.main(["slam", str(vcfg), "--device", dev.type])
    wall3 = time.perf_counter() - t
    rows = np.loadtxt(only_dir(tmp / "run3") / "odom.txt", ndmin=2)
    print(f"[cli] VBR bag (ROS1, LZ4 chunks) at 16x256: {len(rows)} "
          f"poses, x {np.round(rows[:, 1], 4).tolist()}, "
          f"{wall3:.3f} s", flush=True)
    if rows.shape != (6, 8) or not rows[-1, 1] > 0.5 or \
            not np.isfinite(rows).all():
        fail("the VBR bag's run missed tests/test_cli_vendor.py's "
             "gates")
    # the CLI logs every frame: repeat the phase's numbers after the logs
    print(f"[cli] summary: native.available() {native.available()}, "
          f"reader {read_ms:.3f} ms/sweep; slam {n / wall1:.3f} frames/s "
          f"over the command, {np.mean(plain):.3f} ms "
          f"a frame without an update, updates "
          f"{[round(ms, 3) for ms in update_ms]} ms (captured blocks), "
          f"peak device memory {peak1 / 2**30:.3f} GiB, max error "
          f"{err.max():.4f} m, RPE {rpe_mean}, launches {launches}; wall: "
          f"slam {wall1:.3f} s, supervised {wall2:.3f} s (attempts at "
          f"checkpoint frames {starts}, max error {err2.max():.4f} m), VBR "
          f"{wall3:.3f} s", flush=True)
    return rdir, data, n / wall1


# phase 6: the street canyon's world cloud (recon_parity's world size) and
# tools/recon_parity.py's evaluation protocol (2 cm downsample, F-score at
# 0.2 m, truncation 0.5 m both ways, 2,000,000 mesh samples)
WORLD_POINTS = 600_000
MESH_SAMPLES = 2_000_000
RECON_KEYS = ("MAE_accuracy (cm)", "MAE_completeness (cm)",
              "Chamfer_L1 (cm)", "F-score (%)")


def world_reference(tmp: Path) -> Path:
    """The street canyon's world cloud (WORLD_POINTS, seed SEED) as a PLY
    in ``tmp``: eval_recon's reference."""
    from splatloam_tpu_torch.io.ply import write_ply
    world = street_world(np.random.default_rng(SEED), WORLD_POINTS)
    ref = tmp / "world.ply"
    write_ply(ref, {"x": world[:, 0], "y": world[:, 1], "z": world[:, 2]})
    return ref


def mesh_and_score(dev, rdir: Path, method: str, extra: list, tmp: Path,
                   tag: str) -> dict:
    """The port's ``mesh --method method`` on the results directory
    ``rdir`` on ``dev``, then ``eval_recon`` of the mesh against the
    street canyon's world cloud.  Fails if the mesh is empty or not
    finite, if K1 did not launch in the ``mesh`` run, or if a metric is
    not finite.  Returns the run's numbers: faces, mesh wall (s), K1
    launches, keyframe renders (ms), steps (s), eval_recon wall (s) and
    metrics."""
    from splatloam_tpu_torch import cli
    from splatloam_tpu_torch.eval.recon import load_mesh
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.profiling import get_profiler

    ref = world_reference(tmp)
    mesh = tmp / f"mesh_{tag}_{method}.ply"
    torch.cuda.synchronize()
    k1_before = kernels.KERNELS["K1_fwd"].launches
    t = time.perf_counter()
    cli.main(["mesh", str(rdir), "--device", dev.type, "-o", str(mesh),
              *extra])
    wall = time.perf_counter() - t
    k1 = kernels.KERNELS["K1_fwd"].launches - k1_before
    stats = get_profiler().stats
    render_ms = [1e3 * x for x in stats["mesh.render"].samples]
    steps = {k: stats[k].total for k in ("mesh.fuse", "mesh.marching_cubes",
                                         "mesh.poisson") if k in stats}
    verts, faces = load_mesh(mesh)
    print(f"[{tag}] mesh {method}: {len(verts)} vertices, {len(faces)} "
          f"faces in {wall:.3f} s; K1 launches {k1}; keyframe renders "
          f"{[round(x, 3) for x in render_ms]} ms; "
          + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in steps.items()),
          flush=True)
    if len(faces) == 0 or not np.isfinite(verts).all():
        fail(f"mesh --method {method} wrote an empty or non-finite mesh")
    if not k1:
        fail(f"K1 was not launched in mesh --method {method}")
    out = tmp / f"recon_{tag}_{method}.csv"
    t = time.perf_counter()
    cli.main(["eval_recon", str(ref), str(mesh), "--output", str(out),
              "--mesh-sample-point", str(MESH_SAMPLES)])
    wall_e = time.perf_counter() - t
    with open(out) as f:
        row = dict(zip(*[line.rstrip("\n").split(",") for line in f]))
    metrics = {k: float(row[k]) for k in RECON_KEYS}
    print(f"[{tag}] eval_recon {method} against the world cloud "
          f"({WORLD_POINTS} points, {MESH_SAMPLES} mesh samples): "
          f"{wall_e:.3f} s, "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()),
          flush=True)
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"eval_recon of the {method} mesh gave {metrics}")
    return dict(faces=len(faces), wall=wall, k1=k1, render_ms=render_ms,
                steps=steps, wall_e=wall_e, metrics=metrics)


def run_mesh(dev, rdir: Path, tmp: Path) -> None:
    """Phase 6: the port's ``mesh`` (TSDF, then grid Poisson) on phase 5's
    results directory on ``dev``, and ``eval_recon`` of each mesh against
    the street canyon's world cloud (``mesh_and_score``)."""
    summary = []
    for method, extra in (("tsdf", []),
                          ("poisson", ["--method", "poisson",
                                       "--poisson-width", "0.1"])):
        r = mesh_and_score(dev, rdir, method, extra, tmp, "mesh")
        summary.append(f"{method}: {r['faces']} faces, K1 {r['k1']}, "
                       f"render {np.mean(r['render_ms']):.3f} ms/keyframe, "
                       f"mesh {r['wall']:.3f} s, eval_recon "
                       f"{r['wall_e']:.3f} s, "
                       + ", ".join(f"{k} {v:.4f}"
                                   for k, v in r["metrics"].items()))
    # the CLI logs every step: repeat the phase's numbers after the logs
    print(f"[mesh] summary: {'; '.join(summary)}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: multi-device mapping (parallel/) on one card
# ---------------------------------------------------------------------------

PAR_ITERS = 32           # Adam iterations of each sharded update
PAR_WORLD = 4
PAR_TIMEOUT_S = 420      # wall limit of the rank group; then it is killed
PAR_GRAD_TOL = 2e-3      # x max|g|, the kernel path's gradient tolerance
POOL_SPREAD = 3.0        # pool_gap's limit, in single-device spreads
# the render's forward tolerances (tests/test_pallas_raster.py)
RING_TOL = {"alpha": 2e-5, "T": 2e-5, "depth_sum": 2e-4, "normal_sum": 2e-4}
# the partitions of 7(b) and their (data, model) meshes
PAR_PARTS = (("tiles", (2, 2)), ("rows", (2, 2)), ("ring", (1, 4)))
# the kitti.yaml geometry at 100k surfels (4x16 tiles, chunk 256) with a
# list capacity no tile fills, found from the data up to PAR_K_MAX: each
# ring band keeps its own K nearest splats per tile, so where a tile's
# list is full the ring renders splats the single render drops, and no
# comparison would hold
PAR_TILE = dict(tile_h=4, tile_w=16, chunk=256)
PAR_K_MAX = 16384


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_config(cfg, partition: str = "auto", data: int = 1, model: int = 1,
               tile_k: int | None = None):
    cfg_p = copy.deepcopy(cfg)
    cfg_p.mapping.num_iterations = PAR_ITERS - 1
    cfg_p.compute.auto_tile = False
    for k, v in PAR_TILE.items():
        setattr(cfg_p.compute, k, v)
    if tile_k is not None:
        cfg_p.compute.tile_list_capacity = tile_k
    cfg_p.parallel.partition = partition
    cfg_p.parallel.data, cfg_p.parallel.model = data, model
    return cfg_p


def pool_diffs(surf, ref_surf) -> dict:
    """Per active surfel, the norm of each field's difference from the
    reference pool (the same slots; the active masks must be equal)."""
    from splatloam_tpu_torch.model import surfels as S
    if not torch.equal(surf.active.cpu(), ref_surf.active.cpu()):
        fail("the update's active mask differs from the single-device "
             "update's")
    act = ref_surf.active.cpu()
    return {name: torch.linalg.norm(
        (a.cpu()[act] - b.cpu()[act]).reshape(int(act.sum()), -1), dim=1)
        for name, a, b in zip(S.SurfelParams._fields, surf.params,
                              ref_surf.params)}


def diff_stats(diffs: dict) -> dict:
    """{field: (max, 99th percentile)} of per-surfel differences."""
    return {k: (float(d.max()), float(torch.quantile(d.double(), 0.99)))
            for k, d in diffs.items()}


def pool_gap(diffs: dict, spread: dict) -> dict:
    """The pool tolerance: Adam with eps 1e-15 turns any float-order
    change of a gradient into up to a learning rate a step, and over 32
    steps and 100k surfels the largest such difference is a heavy tail
    (the same two runs of phase 3's pool gave quat maxima 1.2x apart).
    So an update is held to the spread of single-device updates that
    differ in float order alone (the ranksum reduction against rmw, fused
    and plan, the same start and keyframes) in bulk: each field's
    99th-percentile per-surfel difference within POOL_SPREAD x the
    largest of theirs (floored at 1e-6).  The max is printed beside.
    Returns {field: (99th-percentile ratio to its limit, max over the
    spread's max)}."""
    out = {}
    for k, (mx, q99) in diff_stats(diffs).items():
        smx, sq99 = spread[k]
        out[k] = (round(q99 / (POOL_SPREAD * sq99 + 1e-6), 4),
                  round(mx / (smx + 1e-6), 4))
    return out


def tiles_formula(cap: int, n_data: int, n_model: int) -> dict:
    """Per-iteration send bytes per device of the "tiles" partition, the
    JAX package's dryrun formula (__graft_entry__.py), by bucket."""
    img_px, f32 = H * W, 4
    depth_b = (n_data - 1) * img_px * f32 // n_data
    out = {}

    def add(kind, g, v):
        if g > 1:
            out[f"{kind}_g{g}"] = out.get(f"{kind}_g{g}", 0) + v
    add("all-gather", n_model, (n_model - 1) * (cap // n_model) * 41)
    add("all-gather", n_data, depth_b)
    add("all-reduce", n_data,
        2 * (n_data - 1) * (cap * 10 * f32 + f32) // n_data)
    add("reduce-scatter", n_data, depth_b)
    return out


def ring_formula(cap: int, n_data: int, n_model: int) -> dict:
    """The ring's per-iteration terms of the same formula: the fold's
    forward and backward (JAX's ppermute hops; here one all-gather and
    its reduce-scatter), the band gradients' psum over "data"."""
    img_px, f32 = H * W, 4
    fold = (n_model - 1) * (img_px // n_data) * 6 * f32
    out = {f"all-gather_g{n_model}": fold,
           f"reduce-scatter_g{n_model}": fold}
    if n_data > 1:
        out[f"all-reduce_g{n_data}"] = 2 * (n_data - 1) * (
            (cap // n_model) * 10 * f32 + f32) // n_data
    return out


def parallel_nccl_one_rank(dev, cfg, model, kf, idx, ref) -> None:
    """Phase 7(a): sharded_optimize_tiles on a 1x1 mesh over NCCL in this
    process (its collectives run on CUDA tensors), held to the
    single-device update with the same keyframe indices."""
    import torch.distributed as dist
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.parallel import (initialize_distributed,
                                              make_mesh, stats)
    from splatloam_tpu_torch.parallel.sharded import (shard_model_state,
                                                      sharded_optimize_tiles)
    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                           device=dev, backend="nccl")
    try:
        mesh = make_mesh(1, 1, device=dev)
        cfg_p = par_config(cfg)
        progs = MapperPrograms(cfg_p, H, W, model.capacity)
        opt = sharded_optimize_tiles(mesh, progs.params, progs.hyper,
                                     cfg_p.mapping, cfg_p.compute)
        s_sh, a_sh = shard_model_state(mesh, model.surfels, model.adam)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        stats.reset()
        t = time.perf_counter()
        s2, a2, ema, it = opt(s_sh, a_sh, kf, idx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / it
        launches = {k: v.launches for k, v in kernels.KERNELS.items()
                    if v.launches}
        counted = stats.counted()
    finally:
        dist.destroy_process_group()
    gap = pool_gap(pool_diffs(s2, ref["pool"][0]), ref["spread"])
    print(f"[parallel] (a) NCCL, 1 rank, tiles 1x1 (backend "
          f"{mesh.backend}, staged {mesh.group('data').staged}): {it} "
          f"iterations, {ms:.3f} ms/iteration (single device "
          f"{ref['ms']:.3f}), loss EMA {float(ema):.5f} (single device "
          f"{ref['ema']:.5f}), pool difference / limit by field "
          f"{gap} (99th percentile / limit, max / the spread's max), "
          f"collective calls "
          f"{counted['calls']}, launches {launches}", flush=True)
    if max(q for q, _ in gap.values()) > 1.0 or it != ref["iters"]:
        fail(f"the NCCL 1x1 update is off the single-device update: pool "
             f"difference / limit {gap}, iterations {it} against "
             f"{ref['iters']}")
    if counted["staged"] or not sum(counted["calls"].values()):
        fail("the NCCL run did not run its collectives on CUDA tensors")
    for k in ("K1_fwd", "K2_bwd", "K3_ranksum"):
        if not launches.get(k):
            fail(f"{k} was not launched on the NCCL 1x1 update")


def parallel_rank(rank: int, port: int, tmp: str) -> None:
    """Phase 7(b), one of PAR_WORLD gloo ranks that share cuda:0: for
    each partition, one iteration's gradient on keyframe 1, its counted
    bytes, and a PAR_ITERS-iteration update, from the pool phase 3 left.
    Writes its results to
    ``tmp``/rank<r>.pt.  The kernels were built by the parent: this rank
    only loads them."""
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.parallel import (initialize_distributed,
                                              make_mesh, stats)
    from splatloam_tpu_torch.parallel import collectives as C
    from splatloam_tpu_torch.parallel import ring, sharded
    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // PAR_WORLD))
    initialize_distributed(f"tcp://127.0.0.1:{port}", PAR_WORLD, rank,
                           device=dev)
    st = torch.load(Path(tmp) / "par_state.pt", map_location=dev,
                    weights_only=False)
    cfg, kf, idx = st["cfg"], st["kf"], st["idx"]
    surf, adam = st["surf"], st["adam"]
    meshes = {shape: make_mesh(*shape, device=dev)
              for shape in ((2, 2), (1, 4))}
    builders = {"tiles": sharded.sharded_optimize_tiles,
                "rows": sharded.sharded_optimize,
                "ring": sharded.sharded_optimize_ring}
    res = {"transport": (meshes[(2, 2)].backend,
                         meshes[(2, 2)].group("data").staged)}
    for part, shape in PAR_PARTS:
        mesh = meshes[shape]
        cfg_p = par_config(cfg, part, *shape)
        progs = MapperPrograms(cfg_p, H, W, surf.capacity)
        opt = builders[part](mesh, progs.params, progs.hyper,
                             cfg_p.mapping, cfg_p.compute)
        perm = None
        s0, a0 = surf, adam
        if part == "ring":
            # keyframe 1's depth bands, as the block's reshard lays them out
            perm = ring.depth_partition_shards(surf, kf.T_cw[1], 4)
            s0 = S.Surfels(S.SurfelParams(*(p[perm] for p in surf.params)),
                           surf.active[perm])
        s_sh, a_sh = sharded.shard_model_state(mesh, s0, a0)
        one = torch.ones((), dtype=torch.long, device=dev)
        tiles = opt.make_tiles(s_sh, kf, one)
        stats.reset()
        _, g = opt.grads(s_sh, kf, one, tiles)
        counted = stats.counted()
        if part == "ring":
            g = S.SurfelParams(*(
                C.all_gather_raw(x.contiguous(),
                                 mesh.group("model"))[torch.argsort(perm)]
                for x in g))
        s_sh, a_sh = sharded.shard_model_state(mesh, surf, adam)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        stats.reset()
        t = time.perf_counter()
        s2, a2, ema, it = opt(s_sh, a_sh, kf, idx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / it
        launches = {k: v.launches for k, v in kernels.KERNELS.items()
                    if v.launches}
        total = stats.counted()
        full_s, full_a = sharded.gather_model_state(mesh, s2, a2)
        res[part] = dict(
            grads=[x.cpu() for x in g] if rank == 0 else None,
            bytes=counted, update_bytes=total, ms=ms, iters=int(it),
            ema=float(ema), launches=launches,
            surf=(S.Surfels(S.SurfelParams(*(x.cpu() for x in
                                             full_s.params)),
                            full_s.active.cpu()) if rank == 0 else None))
    torch.distributed.barrier()
    torch.save(res, Path(tmp) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def parallel_ranks(dev, cfg, model, frames, kf, idx, ref, tmp: Path) -> None:
    """Phase 7(b): PAR_WORLD gloo ranks share cuda:0 (NCCL refuses two
    ranks on one device); each is this script with ``--parallel-rank``,
    under a wall limit after which the whole group is killed."""
    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    torch.save(dict(cfg=cfg, kf=kf, idx=idx, surf=model.surfels,
                    adam=model.adam), tmp / "par_state.pt")
    port = free_port()
    root = Path(__file__).resolve().parent
    procs = []
    t = time.perf_counter()
    for r in range(PAR_WORLD):
        env = dict(os.environ, LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(PAR_WORLD))
        procs.append(subprocess.Popen(
            [sys.executable, str(root / "chip_smoke.py"), "--parallel-rank",
             str(r), str(port), str(tmp)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True))
    logs = []
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        fail(f"the {PAR_WORLD} ranks did not finish within "
             f"{PAR_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    wall = time.perf_counter() - t
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:])
            fail(f"rank {r} of the gloo group failed (rc {p.returncode})")
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(PAR_WORLD)]
    backend, staged = res[0]["transport"]
    print(f"[parallel] (b) {PAR_WORLD} ranks on cuda:0, backend {backend}, "
          f"CUDA tensors staged through host memory: {staged}; the group "
          f"took {wall:.1f} s", flush=True)
    if backend != "gloo" or not staged:
        fail("ranks sharing one card must use gloo with host staging")
    g_ref = ref["grads"]
    cap = model.capacity
    for part, shape in PAR_PARTS:
        r0 = res[0][part]
        act = model.surfels.active.cpu()
        # the ring: every surfel against the single-device band fold, the
        # surfels no early exit reaches against the single render
        checks = ([(r0["grads"], ref["fold_grads"], act),
                   (r0["grads"], g_ref, act & ~ref["affected"])]
                  if part == "ring" else [(r0["grads"], g_ref, act)])
        errs, each = {}, []
        for grads, refs, sel in checks:
            one = {}
            for name, a, b in zip(("xyz", "log_scale", "quat",
                                   "logit_opacity"), grads, refs):
                scale = float(b[act].abs().max())
                one[name] = float((a[sel] - b[sel]).abs().max()) / scale
                errs[name] = max(errs.get(name, 0.0), one[name])
            each.append({k: f"{v:.2e}" for k, v in one.items()})
        if part == "ring":
            print(f"[parallel] (b) ring gradient / max|g|: against the "
                  f"single-device band fold {each[0]}, against the single "
                  f"render on the surfels that see the same slots in both "
                  f"{each[1]}",
                  flush=True)
        if part == "ring":
            aff = act & ref["affected"]
            near = {name: float((a[aff] - b[aff]).abs().amax(0).max()
                                if aff.any() else 0.0)
                    / float(b[act].abs().max())
                    for name, a, b in zip(("xyz", "log_scale", "quat",
                                           "logit_opacity"), r0["grads"],
                                          g_ref)}
            print(f"[parallel] (b) ring: {ref['exit_tiles']} tiles exit "
                  f"early in the single render or a band, the bands list "
                  f"other slots than the whole pool in "
                  f"{ref['differ_tiles']}; the {int(aff.sum())} surfels "
                  f"binned there differ from the single render by "
                  f"max|diff| / max|g| "
                  f"{ {k: f'{v:.2e}' for k, v in near.items()} } (held to "
                  f"the band fold instead)", flush=True)
        progs = MapperPrograms(par_config(cfg, part, *shape), H, W, cap)
        cover, med = check_rerender(None, frames[1], f"parallel {part}",
                                    pool_to(r0["surf"], dev), progs.params)
        if part == "ring":
            # float order alone, pooled over the six single-device
            # updates that differ from their reference in nothing else:
            # the single render's three reductions and the band fold's
            gap = ring_pool_gap(r0["surf"], ref["fold_pool"], {
                k: tuple(max(a, b) for a, b in zip(v, ref["fold_spread"][k]))
                for k, v in ref["spread"].items()})
            print(f"[parallel] (b) ring: the band fold's own spread "
                  f"(ranksum against rmw, fused and plan, paired by "
                  f"position), per field (max, 99th percentile) "
                  f"{ {k: (f'{a:.3e}', f'{b:.3e}') for k, (a, b) in ref['fold_spread'].items()} }"
                  f", its ambiguous pairs up to {ref['fold_ambiguous']}",
                  flush=True)
        else:
            gap = pool_gap(pool_diffs(r0["surf"], ref["pool"][0]),
                           ref["spread"])
        formula = (ring_formula(cap, *shape) if part == "ring" else
                   tiles_formula(cap, *shape) if part == "tiles" else None)
        print(f"[parallel] (b) {part} {shape[0]}x{shape[1]}: grad max|diff|"
              f" / max|g| {({k: f'{v:.2e}' for k, v in errs.items()})} "
              f"(tol {PAR_GRAD_TOL}); update {r0['iters']} iterations, "
              f"ms/iteration by rank "
              f"{[round(x[part]['ms'], 3) for x in res]} (single device "
              f"{ref['ms']:.3f}"
              + (f", band fold {ref['fold_ms']:.3f}" if part == "ring"
                 else "")
              + f"), loss EMA {r0['ema']:.5f} (single {ref['ema']:.5f}"
              + (f", band fold {ref['fold_ema']:.5f}" if part == "ring"
                 else "")
              + f"), pool difference / limit "
              f"{gap} (99th percentile / limit, max / the spread's max), "
              f"re-render "
              f"coverage {cover:.4f}, median L1 {med:.4f} m (single "
              f"{ref['rerender'][0]:.4f}, {ref['rerender'][1]:.4f} m); "
              f"send bytes "
              f"per iteration per rank {r0['bytes']['send']} (formula "
              f"{formula if formula is not None else 'none in the JAX dryrun'}"
              f"), staged {r0['bytes']['staged']} bytes; launches by rank "
              f"{[x[part]['launches'] for x in res]}", flush=True)
        if max(errs.values()) > PAR_GRAD_TOL:
            fail(f"the {part} partition's gradient is off the single "
                 f"render's: max|diff| / max|g| {errs} (tol {PAR_GRAD_TOL})")
        if max(v[0] for k, v in gap.items() if k != "ambiguous") > 1.0 or \
                gap.get("ambiguous", 0) > 0.01 * int(model.no_gaussians) or \
                r0["iters"] != ref["iters"]:
            fail(f"the {part} update is off the single-device update: "
                 f"pool difference / limit {gap} (99th percentile / limit, "
                 f"max / the spread's max; ambiguous pairs up to "
                 f"{0.01 * int(model.no_gaussians):.0f}), iterations "
                 f"{r0['iters']} against {ref['iters']}")
        if formula is not None:
            for k, v in formula.items():
                if r0["bytes"]["send"].get(k, 0) != v:
                    fail(f"{part}: counted {k} "
                         f"{r0['bytes']['send'].get(k, 0)} != formula {v}")
        for x in res:
            for k in ("K1_fwd", "K2_bwd", "K3_ranksum"):
                if not x[part]["launches"].get(k):
                    fail(f"{k} was not launched on a rank's {part} update")
    rg = ref["ring_gap"]
    print(f"[parallel] (b) ring forward at model 4 against the single "
          f"render, max gap by tile class (tiles, pixels with a final T <= "
          f"T_EPS): same slots, no exit ({rg['n'][0]} tiles) / tolerance "
          f"{({k: f'{v[0]:.3e}/{RING_TOL[k]:.0e}' for k, v in rg['gap'].items()})}"
          f"; same slots, an exit ({rg['n'][1]} tiles, {rg['n_px']} pixels)"
          f" / bound "
          f"{({k: f'{v[1]:.3e}/{rg['bound'][k]:.3e}' for k, v in rg['gap'].items()})}"
          f"; other slots in a band ({rg['n'][2]} tiles, not held) "
          f"{({k: f'{v[2]:.3e}' for k, v in rg['gap'].items()})}",
          flush=True)
    for k, (same, at_exit, _) in rg["gap"].items():
        if same > RING_TOL[k] or at_exit > rg["bound"][k] + RING_TOL[k]:
            fail(f"the ring's {k} is off the single render beyond its "
                 f"early-exit bound: same slots {same:.3e} (tol "
                 f"{RING_TOL[k]:.0e}), at an exit {at_exit:.3e} (bound "
                 f"{rg['bound'][k]:.3e} + {RING_TOL[k]:.0e})")


def pool_to(surf, dev):
    from splatloam_tpu_torch.model import surfels as S
    return S.Surfels(S.SurfelParams(*(x.to(dev) for x in surf.params)),
                     surf.active.to(dev))


def ring_pool_diffs(surf, ref_surf) -> tuple[dict, int]:
    """A depth-ordered pool against another: both re-lay the pool out in
    depth order every block, and float-order differences may swap
    near-equal depths, so the pools are paired by position: the same
    number of active surfels; xyz by the distance of each surfel to its
    nearest reference surfel and back; the other fields on the pairs
    whose nearest match is unambiguous (the second nearest at least 10x
    farther).  -> (per-surfel differences as pool_diffs gives them, the
    number of ambiguous pairs)."""
    from scipy.spatial import cKDTree
    from splatloam_tpu_torch.model import surfels as S
    a_s, a_r = surf.active.cpu().numpy(), ref_surf.active.cpu().numpy()
    if a_s.sum() != a_r.sum():
        fail(f"the ring update changed the number of active surfels "
             f"({int(a_s.sum())} against {int(a_r.sum())})")
    xs = surf.params.xyz.cpu().numpy()[a_s]
    xr = ref_surf.params.xyz.cpu().numpy()[a_r]
    d, j = cKDTree(xr).query(xs, k=2)
    back, _ = cKDTree(xs).query(xr)
    sure = d[:, 1] > 10.0 * d[:, 0]
    diffs = {"xyz": torch.from_numpy(np.concatenate([d[:, 0], back]))}
    for name, a, b in zip(S.SurfelParams._fields[1:], surf.params[1:],
                          ref_surf.params[1:]):
        x = a.cpu().numpy()[a_s][sure] - b.cpu().numpy()[a_r][j[sure, 0]]
        diffs[name] = torch.linalg.norm(
            torch.from_numpy(x).reshape(int(sure.sum()), -1), dim=1)
    return diffs, int((~sure).sum())


def ring_pool_gap(surf, ref_surf, spread: dict) -> dict:
    """The ring's pool against band_fold_update's, by position
    (ring_pool_diffs), each field as in pool_gap; also returns the number
    of ambiguous pairs."""
    diffs, ambiguous = ring_pool_diffs(surf, ref_surf)
    out = pool_gap(diffs, spread)
    out["ambiguous"] = ambiguous
    return out


def band_channels(q, a, T_cw, K, rp, tiles) -> dict:
    """One depth band's segment state, binned by ``tiles``."""
    from splatloam_tpu_torch.ops.rasterizer.api import rasterize
    c = rasterize(q.xyz, torch.exp(q.log_scale), q.quat,
                  torch.sigmoid(q.logit_opacity) * a, T_cw, K, rp,
                  tiles=tiles)
    return dict(T=c["final_T"], depth_sum=c["depth_sum"], alpha=c["alpha"],
                normal_sum=c["normal_sum"])


def band_tiles(surf, T_cw, K, rp, margin_px: float) -> list:
    """Each of the PAR_WORLD depth bands of a pool in band order, binned
    with the mapper's margin, as the partitions bin (where a tile exits
    early, the chunk its exit falls in depends on the list, margin
    entries included)."""
    from splatloam_tpu_torch.ops.rasterizer.api import prepare_tiles
    rows = surf.capacity // PAR_WORLD
    out = []
    with torch.no_grad():
        for b in range(PAR_WORLD):
            q = [x[b * rows:(b + 1) * rows] for x in surf.params]
            a = surf.active[b * rows:(b + 1) * rows]
            out.append(prepare_tiles(q[0], torch.exp(q[1]), q[2],
                                     torch.sigmoid(q[3]) * a, T_cw, K, rp,
                                     margin_px=margin_px))
    return out


def band_fold_loss(progs, p, act, T_cw, K, depth, valid, tiles):
    """The mapper's loss on the PAR_WORLD bands of a depth-ordered pool
    rendered one by one on this device and folded in order: the ring's
    semantics without its collectives.  -> (loss, the bands' states,
    their fold)."""
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.ops.rasterizer.api import _decode
    from splatloam_tpu_torch.parallel import ring
    rp = progs.params._replace(with_median=False, with_dist=False)
    rows = act.shape[0] // PAR_WORLD
    segs = [band_channels(
        S.SurfelParams(*(x[b * rows:(b + 1) * rows] for x in p)),
        act[b * rows:(b + 1) * rows], T_cw, K, rp, tiles[b])
        for b in range(PAR_WORLD)]
    acc = segs[0]
    for seg in segs[1:]:
        acc = ring.ring_combine(acc, seg)
    zeros = torch.zeros_like(acc["alpha"])
    pkg = _decode(dict(acc, median=zeros, dist=zeros,
                       radii=torch.zeros_like(act, dtype=torch.float32)),
                  T_cw, K, 0.0)
    return (progs._image_losses(pkg, depth, valid)
            + progs._scale_penalty(torch.exp(p.log_scale), act)), segs, acc


def band_fold_update(cfg, progs, surf, adam, kf, idx):
    """The ring partition's update on this device: MapperPrograms'
    block loop, each block re-laid out in the view's depth order (the
    ring's reshard key) and each iteration on band_fold_loss."""
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.slam.mapper import run_block_loop
    rp = progs.params._replace(with_median=False, with_dist=False)
    mc = cfg.mapping
    rebin = max(1, int(cfg.compute.rebin_every))

    def reshard(s, a, i):
        T_cw = kf.T_cw[i]
        pc = s.params.xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        key = torch.where(s.active, torch.linalg.norm(pc, dim=-1),
                          float("inf"))
        perm = torch.sort(key, stable=True).indices

        def take(t):
            return S.SurfelParams(*(x[perm] for x in t))
        return (S.Surfels(take(s.params), s.active[perm]),
                S.AdamState(take(a.mu), take(a.nu), a.step))

    def one_iter(s, a, i, tiles):
        p = S.SurfelParams(*(x.detach().requires_grad_(True)
                             for x in s.params))
        loss, *_ = band_fold_loss(progs, p, s.active, kf.T_cw[i],
                                  kf.K[i], kf.depth[i], kf.valid[i], tiles)
        g = S.SurfelParams(*torch.autograd.grad(loss, p))
        s2, a2 = S.adam_step(s, a, g, progs.hyper)
        return s2, a2, loss.detach()

    return run_block_loop(
        surf, adam, idx, num_iters=progs.n_iters(), rebin=rebin,
        early=bool(mc.early_stop_enable),
        patience_blocks=max(1, int((mc.early_stop_patience or 100)
                                   // rebin)),
        es_threshold=float(mc.early_stop_threshold or 0.01),
        make_tiles=lambda s, i: band_tiles(s, kf.T_cw[i], kf.K[i], rp,
                                           cfg.compute.bin_margin_px),
        one_iter=one_iter, reshard=reshard)


def ring_references(cfg, progs, surf, adam, kf, idx, tiles) -> dict:
    """The ring's single-device references: at keyframe 1 the gradient of
    band_fold_loss (every surfel) and the surfels an early exit can reach;
    the update of band_fold_update, and the spread of its updates under
    the other reductions (its float order alone).  K1 stops a tile once every pixel's
    T <= T_EPS; a band renders from T = 1, so where a render of a tile
    exits (the single render's, or a band's) the ring and the single
    render composite different slots, and the gradient of every surfel
    binned there differs by terms up to T_EPS / (1 - ALPHA_MAX) of a
    channel's cotangent.  Every other surfel sees the same slots in both
    and must get the same gradient.  So must every surfel of a tile whose
    slots the bands list alike: the binner's tiered windows give a band
    its own budget of wide splats (binning._emit_sorted_keys), so a wide
    splat may reach other tiles binned in its band than in the whole
    pool; tiles whose slot sets differ count as reached too."""
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.ops.rasterizer import binning
    from splatloam_tpu_torch.ops.rasterizer.api import rasterize
    from splatloam_tpu_torch.ops.rasterizer.common import T_EPS
    from splatloam_tpu_torch.parallel import ring
    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    one = torch.ones((), dtype=torch.long, device=surf.active.device)
    T_cw, K = kf.T_cw[one], kf.K[one]
    rp = progs.params._replace(with_median=False, with_dist=False)
    perm = ring.depth_partition_shards(surf, T_cw, PAR_WORLD)
    sp = S.Surfels(S.SurfelParams(*(x[perm] for x in surf.params)),
                   surf.active[perm])
    btiles = band_tiles(sp, T_cw, K, rp, cfg.compute.bin_margin_px)
    p = S.SurfelParams(*(x.detach().requires_grad_(True)
                         for x in sp.params))
    loss, segs, acc = band_fold_loss(progs, p, sp.active, T_cw, K,
                                     kf.depth[one], kf.valid[one], btiles)
    g = torch.autograd.grad(loss, p)
    inv = torch.argsort(perm)
    # tiles where a render exits early: every pixel at T <= T_EPS
    with torch.no_grad():
        single_c = rasterize(surf.params.xyz, surf.scaling, surf.rotation,
                             surf.opacity, T_cw, K, rp, tiles=tiles)

        def exits(T):
            t = binning.tile_image(T, rp.tile_h, rp.tile_w)
            return (t <= T_EPS).all(dim=1)
        hit = exits(single_c["final_T"])
        for seg in segs:
            hit |= exits(seg["T"].detach())
        exit_tiles = int(hit.sum())
        # (tile, surfel) pairs of the single binning and of the bands'
        cap1 = surf.capacity + 1

        def pairs(t, ids_of):
            slot = torch.arange(t.lists.shape[1], device=hit.device)
            live = slot[None, :] < t.counts[:, None]
            tile = torch.arange(t.lists.shape[0], device=hit.device)
            tile = tile[:, None].expand_as(t.lists)[live]
            return tile * cap1 + ids_of(t.lists[live].long())
        rows = surf.capacity // PAR_WORLD
        single = pairs(tiles, lambda i: i)
        bands = torch.cat([pairs(bt, lambda i, b=b: perm[b * rows + i])
                           for b, bt in enumerate(btiles)])
        odd = torch.cat([single[~torch.isin(single, bands)],
                         bands[~torch.isin(bands, single)]])
        differ = torch.zeros_like(hit)
        differ[odd // cap1] = True
        # the forward's gap by tile class: the ring's semantics (the band
        # fold) against the single render
        cls = torch.where(differ, 2, hit.long())    # 0 same, 1 exit, 2 other

        def per_class(a, b):
            d = (a.detach() - b).abs()
            d = d.amax(-1) if d.dim() == 3 else d
            dt = binning.tile_image(d, rp.tile_h, rp.tile_w).amax(1)
            return tuple(float(dt[cls == c].max()) if (cls == c).any()
                         else 0.0 for c in range(3))
        gap = {k: per_class(acc[k], single_c[k2]) for k, k2 in
               (("alpha", "alpha"), ("T", "final_T"),
                ("depth_sum", "depth_sum"), ("normal_sum", "normal_sum"))}
        px_exit = binning.tile_image(
            torch.minimum(acc["T"].detach(), single_c["final_T"]),
            rp.tile_h, rp.tile_w)[cls == 1] <= T_EPS
        pc = surf.params.xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        depth_max = float(torch.linalg.norm(pc, dim=-1)[surf.active].max())
        ring_gap = dict(gap=gap, n=[int((cls == c).sum()) for c in range(3)],
                        n_px=int(px_exit.sum()),
                        bound=ring.early_exit_bound(depth_max))
        hit |= differ
        affected = torch.zeros(cap1, dtype=torch.bool, device=hit.device)
        for key in (single, bands):
            affected[key[hit[key // cap1]] % cap1] = True
    torch.cuda.synchronize()
    t = time.perf_counter()
    s_f, _, ema_f, it_f = band_fold_update(cfg, progs, surf, adam, kf, idx)
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t) * 1e3 / int(it_f)
    # the band fold's own float-order spread, paired by position as the
    # ring's pool is: its block-start depth sorts and per-band wide-splat
    # budgets make it more chaotic than the single render
    fold_spread, fold_ambiguous = {}, 0
    for scatter in ("rmw", "fused", "plan"):
        cfg_m = copy.deepcopy(cfg)
        cfg_m.compute.scatter = scatter
        progs_m = MapperPrograms(cfg_m, H, W, surf.capacity)
        s_m, *_ = band_fold_update(cfg_m, progs_m, surf, adam, kf, idx)
        diffs, amb = ring_pool_diffs(s_m, s_f)
        fold_ambiguous = max(fold_ambiguous, amb)
        for k, v in diff_stats(diffs).items():
            fold_spread[k] = tuple(max(a, b) for a, b in
                                   zip(fold_spread.get(k, (0.0, 0.0)), v))
    return {"fold_grads": [x[inv].detach().cpu() for x in g],
            "exit_tiles": exit_tiles, "differ_tiles": int(differ.sum()),
            "ring_gap": ring_gap,
            "affected": affected[:-1].cpu(),
            "fold_pool": s_f, "fold_ema": float(ema_f),
            "fold_spread": fold_spread, "fold_ambiguous": fold_ambiguous,
            "fold_ms": fold_ms}


def parallel_cli(dev, seq_args, poses, fps5: float, tmp: Path) -> None:
    """Phase 7(c): ``slam`` under ``python -m torch.distributed.run
    --nproc-per-node 4`` with parallel.data=2 parallel.model=2 on phase
    5's KITTI-layout sweeps; only rank 0 writes results."""
    root = Path(__file__).resolve().parent
    out = tmp / "run_par"
    t = time.perf_counter()
    rc, log = run_in_group(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(PAR_WORLD), "--master-port", str(free_port()), "-m",
         "splatloam_tpu_torch", "slam", ODOM_CFG, "--device", "cuda",
         *seq_args, f"output.folder={out}", "parallel.data=2",
         "parallel.model=2"], dict(os.environ), PAR_TIMEOUT_S)
    wall = time.perf_counter() - t
    if rc != 0:
        print(log[-6000:])
        fail(f"torchrun slam failed (rc {rc})")
    err = odom_error(only_dir(out) / "odom.txt", poses)
    print(f"[parallel] (c) torchrun --nproc-per-node {PAR_WORLD} slam "
          f"{ODOM_CFG} parallel.data=2 parallel.model=2: {len(poses)} "
          f"frames, {len(poses) / wall:.3f} frames/s over the command's "
          f"{wall:.3f} s (phase 5, one process: {fps5:.3f}); max "
          f"translation error {err.max():.4f} m (gate {TRACK_GATE_M}); "
          f"ranks sharing one card measure correctness, not scaling",
          flush=True)
    if err.max() > TRACK_GATE_M:
        fail(f"the torchrun run is off GT by up to {err.max():.4f} m")


def run_parallel(dev, slice_state, seq_args, poses, fps5: float,
                 tmp: Path) -> None:
    """Phase 7: (a) NCCL with one rank in this process, (b) PAR_WORLD gloo
    ranks sharing the card at full width, (c) the command line under
    torchrun.  The single-device references come from phase 3's pool."""
    from splatloam_tpu_torch.ops.rasterizer.api import prepare_tiles
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    cfg, mapper, model, frames = slice_state
    kf = mapper._stack_keyframes(model.kf_stack["K"].shape[0])
    surf = model.surfels
    print("[parallel] the sharded programs run uncaptured (their gloo "
          "collectives cannot be captured into a CUDA graph); the "
          "single-device references run captured, as Mapper does on "
          "CUDA", flush=True)

    def bin_at(cfg_b):
        progs = MapperPrograms(cfg_b, H, W, model.capacity)
        return progs, prepare_tiles(
            surf.params.xyz, surf.scaling, surf.params.quat, surf.opacity,
            kf.T_cw[1], kf.K[1], progs.params,
            margin_px=cfg.compute.bin_margin_px)

    _, tiles = bin_at(par_config(cfg, tile_k=PAR_K_MAX))
    k_max = int(tiles.counts.max())
    chunk = PAR_TILE["chunk"]
    tile_k = (k_max // chunk + 1) * chunk
    print(f"[parallel] {PAR_TILE['tile_h']}x{PAR_TILE['tile_w']} tiles: the "
          f"fullest tile of keyframe 1 holds {k_max} splats (kitti.yaml's "
          f"capacity 768 fills {int((tiles.counts >= 768).sum())} of "
          f"{tiles.counts.numel()} tiles); phase 7 runs at list capacity "
          f"{tile_k}", flush=True)
    if k_max >= PAR_K_MAX:
        fail("a tile list is full: the partitions would not be comparable")
    cfg = par_config(cfg, tile_k=tile_k)
    progs, tiles = bin_at(cfg)
    idx = torch.ones((progs.n_blocks(),), dtype=torch.long, device=dev)
    # the single-device references: keyframe 1's gradient, the update
    p = S.SurfelParams(*(x.detach().requires_grad_(True)
                         for x in surf.params))
    one = torch.ones((), dtype=torch.long, device=dev)
    g = torch.autograd.grad(progs._loss(p, surf.active, kf, one, tiles), p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s2, a2, ema, it = progs.optimize(surf, model.adam, kf, idx)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / int(it)
    spread = {}
    for scatter in ("rmw", "fused", "plan"):
        cfg_m = copy.deepcopy(cfg)
        cfg_m.compute.scatter = scatter
        s_m, *_ = MapperPrograms(cfg_m, H, W, model.capacity).optimize(
            surf, model.adam, kf, idx)
        for k, v in diff_stats(pool_diffs(s_m, s2)).items():
            spread[k] = tuple(max(a, b) for a, b in
                              zip(spread.get(k, (0.0, 0.0)), v))
    print(f"[parallel] single-device spread (ranksum against rmw, fused "
          f"and plan, {int(it)} iterations from one start), per field "
          f"(max, 99th percentile) of the per-surfel difference: "
          f"{ {k: (f'{a:.3e}', f'{b:.3e}') for k, (a, b) in spread.items()} }",
          flush=True)
    ref = dict(grads=[x.cpu() for x in g], pool=(s2, a2), ema=float(ema),
               spread=spread,
               iters=int(it), ms=ms,
               rerender=check_rerender(None, frames[1],
                                       "parallel single device", s2,
                                       progs.params))
    ref.update(ring_references(cfg, progs, surf, model.adam, kf, idx,
                               tiles))
    parallel_nccl_one_rank(dev, cfg, model, kf, idx, ref)
    parallel_ranks(dev, cfg, model, frames, kf, idx, ref, tmp)
    parallel_cli(dev, seq_args, poses, fps5, tmp)


# ---------------------------------------------------------------------------
# phase 8: the reconstruction configuration through slam, mesh, eval_recon
# ---------------------------------------------------------------------------

RECON_CFG = "configs/ncd/quad-easy-mapping-gt.yaml"
# the Newer College Dataset's Ouster OS0-128: 90 degrees of vertical field
# of view, 10 Hz, carried by hand at a walk (0.1 m a sweep); one keyframe
# every 6 frames (tracking.keyframe_threshold_nframes 5: a new keyframe
# once more than 5 frames were tracked), so 25 sweeps give the updates at
# frames 0, 6, 12, 18, 24.  At 0.3 m a sweep (3 m/s) the newest keyframe
# re-renders at coverage 0.884 (PERF.md, the reconstruction findings)
RECON_FOV_DEG = (-45.0, 45.0)
RECON_SWEEPS, RECON_STEP_M = 25, 0.1
# the GT poses go through float64 only, and odom.txt (TUM, 4 decimals)
# holds them exactly where they sit on that grid
RECON_POSE_TOL_M = 1e-5
# mesh's TSDF voxel: at the default 0.1 m, the 90-degree field of view
# sees the canyon's cross walls 113 m apart and its facades' tops, a grid
# over eval/tsdf.py's MAX_VOXELS (1140 x 217 x 139 voxels); the
# truncation stays 3 voxels, as the defaults' 0.1 / 0.3
RECON_MESH_ARGS = ["--voxel-size", "0.15", "--trunc", "0.45"]
# eval_recon's MAE accuracy limit (cm), written before the chip run from
# a CPU rehearsal at 32x256 (16.3 cm there; PERF.md section 2)
RECON_ACC_LIMIT_CM = 20.0
# phase 8's peak device memory on the H100 when the blocks ran uncaptured
# (PERF.md, the reconstruction findings)
RECON_PEAK_UNCAPTURED_GIB = 0.517


class ReconProbe:
    """Observes the mapper inside ``cli.main(["slam", ...])`` without
    changing what it computes: wraps ``Mapper.update_model`` (the pool's
    capacity before and after each update, its active surfels and
    iterations, the mapper itself) and ``MapperPrograms.optimize`` (the
    tiles whose list reached K at each update's first rebin, binned again
    from the pool and keyframe that rebin sees: inside a captured graph
    the rebin itself reads nothing back).  Restores both on exit."""

    def __init__(self):
        self.updates: list[dict] = []
        self.mapper = None

    def __enter__(self):
        from splatloam_tpu_torch.slam import mapper as mapper_mod
        self._mod = mapper_mod
        self._update = mapper_mod.Mapper.update_model
        self._optimize = mapper_mod.MapperPrograms.optimize
        probe = self

        def update_model(mapper, frame, initialize_model=False):
            probe.mapper = mapper
            rec = dict(cap_before=mapper.model.capacity, k_full=None)
            probe.updates.append(rec)
            probe._update(mapper, frame, initialize_model)
            rec.update(cap=mapper.model.capacity,
                       active=mapper.model.no_gaussians,
                       iters=mapper.last_iters)

        def optimize(progs, surfels, adam, kf, kf_indices, capture=None):
            tiles = progs.make_tiles(surfels, kf, kf_indices[0])
            k = tiles.lists.shape[-1]
            probe.updates[-1]["k_full"] = (int((tiles.counts >= k).sum()),
                                           tiles.counts.numel(), k)
            return probe._optimize(progs, surfels, adam, kf, kf_indices,
                                   capture)

        mapper_mod.Mapper.update_model = update_model
        mapper_mod.MapperPrograms.optimize = optimize
        return self

    def __exit__(self, *exc):
        self._mod.Mapper.update_model = self._update
        self._mod.MapperPrograms.optimize = self._optimize


def tum_error(odom_file: Path, poses) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame translation error (m) and rotation error (the largest
    entry of R - R_gt) of a TUM-format odom.txt (t x y z qx qy qz qw)
    against GT."""
    from splatloam_tpu_torch.io.rotations import (quat_wxyz_from_xyzw,
                                                  rotmat_from_quat)
    est = np.loadtxt(odom_file, ndmin=2)
    if len(est) != len(poses):
        fail(f"{odom_file} holds {len(est)} poses, not {len(poses)}")
    gt = np.stack(poses)
    R = rotmat_from_quat(quat_wxyz_from_xyzw(est[:, 4:8]))
    return (np.linalg.norm(est[:, 1:4] - gt[:, :3, 3], axis=-1),
            np.abs(R - gt[:, :3, :3]).max(axis=(1, 2)))


def wide_splat_overflow(surf, cam, params, margin_px: float) -> dict:
    """The splats of ``surf`` seen from ``cam`` that need the sorted
    binner's tier-2 or tier-3 window, against the budgets it keeps for
    them (ops/rasterizer/binning.py ``_emit_sorted_keys``: tier 2 the
    max(256, n / 16) widest, tier 3 the max(64, n / 256) widest, n the
    pool's rows).  A splat past its tier's budget is listed only in the
    windows of the tiers below: the binner's behaviour, shared with the
    JAX package, counted here, with the (tile, splat) pairs it costs: the
    tile lists of the exact binner (every tile a splat's extent reaches)
    against the sorted binner's, neither capped."""
    from splatloam_tpu_torch.ops.rasterizer import binning, common
    th, tw = params.tile_h, params.tile_w
    with torch.no_grad():
        packed = common.pack_surfels(surf.params.xyz, surf.scaling,
                                     surf.rotation, surf.opacity, cam.T_cw,
                                     cam.K)
        alive = packed.radius_px > 0
        packed.radius_px = torch.where(alive, packed.radius_px + margin_px,
                                       0.0)
        packed.extent_px = torch.where(packed.extent_px > 0,
                                       packed.extent_px + margin_px, 0.0)
        n, n_alive = packed.depth.shape[0], int(alive.sum())
        pairs_sorted = int(binning.build_tile_lists_sorted(
            packed, params.height, params.width, th, tw, n_alive,
            params.cap_ty, params.cap_tx)[1].sum())
        pairs_exact = int(binning.build_tile_lists(
            packed.map(lambda t: t[alive]), params.height, params.width,
            th, tw, n_alive)[1].sum())
    rx, ry = packed.extent_px[:, 0], packed.extent_px[:, 1]
    ty, tx = params.height // th, params.width // tw
    w2_ty, w2_tx = min(params.cap_ty, 2 * ty - 1), min(params.cap_tx, tx)
    need2 = int((alive & ((rx > tw) | (ry > th))).sum())
    need3 = int((alive & ((rx > (w2_tx // 2) * tw)
                          | (ry > (w2_ty // 2) * th))).sum())
    k2, k3 = min(n, max(256, n // 16)), min(n, max(64, n // 256))
    return dict(alive=n_alive, need2=need2, k2=k2,
                over2=max(0, need2 - k2), need3=need3, k3=k3,
                over3=max(0, need3 - k3), pairs_exact=pairs_exact,
                pairs_sorted=pairs_sorted)


def check_recon_kernels(mapper, frame, rng) -> dict:
    """K1, K2 and K3 on the last update's pool at keyframe ``frame``, with
    the mapper's render parameters (128x1024: 2048 tiles): K1's outputs
    against its plain version (and K1, K7 against the float64 plain
    version, ``check_fwd``), K2's rows and K3's sum of them against their
    plain versions at phase 1's tolerances, and the gradient by surfel
    through K2 + K3 against the plain versions' at the repo's gradient
    tolerance, 2e-3 x max|g|; each kernel timed (graph replay) with its
    bound from this run's data.  -> {kernel: (ms, bound ms)}."""
    from splatloam_tpu_torch.ops.rasterizer import binning, common, kernels
    from splatloam_tpu_torch.ops.rasterizer.cuda_raster import (
        RS_GROUP, prepare_tiles)

    model = mapper.model
    progs = mapper.programs_for(frame.camera.height, frame.camera.width,
                                model.capacity)
    params = progs.params
    cam = frame.camera_in_model()
    s = model.surfels
    scene = (s.params.xyz, s.scaling, s.rotation, s.opacity, cam.T_cw,
             cam.K)
    with torch.no_grad():
        tiles = prepare_tiles(*scene, params,
                              margin_px=mapper.cfg.compute.bin_margin_px)
        F = binning.pack_features(common.pack_surfels(*scene)).contiguous()
    args = (F, tiles.lists, tiles.counts, tiles.rays_t, tiles.pix_t)
    chunk, n_rows = params.chunk, F.shape[0]
    out, tb, _, ms1, _ = check_fwd("K1_fwd[recon]", kernels, args, chunk,
                                   False, False, timed=True, tag="recon")
    g = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32),
                     device=out.device)
    bkw = dict(chunk=chunk, width=params.width, with_dist=False)
    bargs = (*args, tb, out, g)
    dFg = kernels.raster_bwd(*bargs, **bkw)
    dFg_p = kernels.raster_bwd_plain(*bargs, **bkw)
    plan = tiles.plan
    r_alloc = binning._ranksum_alloc(n_rows, RS_GROUP)
    pad_rank = plan.rank_of_id[n_rows - 1:]

    def k3_args(rows):
        return (rows.reshape(-1, 16), plan.pos, plan.ranks, pad_rank,
                r_alloc)

    dFc = kernels.ranksum_rows(*k3_args(dFg))
    dFc_k3p = kernels.ranksum_rows_plain(*k3_args(dFg))
    dFc_p = kernels.ranksum_rows_plain(*k3_args(dFg_p))
    torch.cuda.synchronize()
    # phase 1's tolerances: K2's rows at 2e-3 of the largest row entry
    # (galpha's 1/max(1 - alpha, 1e-3) magnifies the float order), K3 at
    # 1e-5 of its largest sum (the same rows in another order)
    real = (torch.arange(tiles.lists.shape[1], device=F.device)[None, :]
            < tiles.counts[:, None])
    err2 = float((dFg - dFg_p)[real].abs().max())
    tol2 = 2e-3 * float(dFg_p.abs().max())
    err3 = float((dFc - dFc_k3p).abs().max())
    tol3 = 1e-5 * max(1.0, float(dFc_k3p.abs().max()))
    by_id = plan.rank_of_id.long()
    grad, grad_p = dFc[by_id][:-1], dFc_p[by_id][:-1]
    err_g = float((grad - grad_p).abs().max())
    tol_g = 2e-3 * float(grad_p.abs().max())
    print(f"[recon] K2 + K3 gradient by surfel vs the plain versions': "
          f"max_abs_err {err_g:.3e} (tol {tol_g:.3e})", flush=True)
    if not err_g <= tol_g:
        fail(f"the K2 + K3 gradient at 2048 tiles disagrees with the plain "
             f"versions': {err_g} > {tol_g}")
    ms2 = time_ms(lambda: kernels.raster_bwd(*bargs, **bkw))
    pms2 = event_ms(lambda: kernels.raster_bwd_plain(*bargs, **bkw), 3)
    report("K2_bwd[recon]", err2, tol2, ms2, pms2)
    rows = dFg.reshape(-1, 16)
    real3, n_real3, (b3, by3) = k3_bound(plan, r_alloc)
    rank_real, rows_real3 = plan.ranks[real3].long(), rows[
        plan.pos[real3].long()]
    ms3 = time_ms(lambda: kernels.ranksum_rows(*k3_args(dFg)))
    pms3 = event_ms(lambda: kernels.ranksum_rows_plain(*k3_args(dFg)))
    lib3 = time_ms(lambda: rows.new_zeros((r_alloc, 16)).index_add_(
        0, rank_real, rows_real3))
    report("K3_ranksum[recon]", err3, tol3, ms3, pms3, lib3)
    confirm_k3_cause(kernels, rows, plan, r_alloc, n_rows,
                     "the recon pool's plan")
    pairs, _, (b1, by1), (b2, by2) = fwd_bwd_bounds(
        args, out, tb, g, int(real.sum()), chunk)
    print(f"[recon] kernel shapes: {tiles.lists.shape[0]} tiles x "
          f"{tiles.rays_t.shape[1]} px, K {tiles.lists.shape[1]}, pool "
          f"rows {n_rows - 1}, composited pairs {pairs:.0f}, ranksum "
          f"entries {plan.pos.numel()} ({n_real3} real); bounds K1 "
          f"{b1:.4f} ms ({by1}), K2 {b2:.4f} ms ({by2}), K3 {b3:.4f} ms "
          f"({by3})", flush=True)
    mc = mapper.cfg.mapping
    k11_args = (out, cam.depth[None], cam.valid[None], cam.K[None],
                cam.T_cw[None])
    k11_kw = dict(tile_h=params.tile_h, tile_w=params.tile_w,
                  lambda_normal=mc.opt_lambda_normal,
                  lambda_alpha=mc.opt_lambda_alpha,
                  depth_ratio=mapper.cfg.opt.depth_ratio)
    err11, _ = hold_image_loss("K11_image_loss[recon]", kernels, k11_args,
                               k11_kw)
    ms11 = time_ms(lambda: kernels.image_loss(*k11_args, **k11_kw))
    pms11 = event_ms(lambda: kernels.image_loss_plain(*k11_args, **k11_kw),
                     5)
    b11, by11 = image_loss_bound(k11_args)
    report("K11_image_loss[recon]", err11, 1e-4, ms11, pms11)
    print(f"[recon] K11 on the keyframe's render: {ms11:.4f} ms, bound "
          f"{b11:.4f} ms ({by11}), plain version {pms11:.4f} ms", flush=True)
    return {"K1_fwd": (ms1, b1), "K2_bwd": (ms2, b2), "K3_ranksum": (ms3, b3),
            "K11_image_loss": (ms11, b11)}


def run_recon(dev, tmp: Path, overrides=()):
    """Phase 8: configs/ncd/quad-easy-mapping-gt.yaml (the reconstruction
    experiment: GT poses, 500 iterations an update, densify 0.4, a
    keyframe every 6 frames, 30-keyframe submaps) on RECON_SWEEPS sweeps of
    the street canyon cast in the OS0-128's field of view
    (``sensor_raster``), written in the KITTI layout and run through ``cli.main(["slam",
    ...])`` with only the data section and the output folder overridden
    (``overrides``: more, for a rehearsal at a small size), then ``mesh``
    (TSDF) and ``eval_recon`` against the world cloud; then each keyframe
    re-rendered, the wide splats against the binner's budgets, and K1, K2,
    K3 on the last pool (``check_recon_kernels``).  Returns the mapper
    of the run."""
    from splatloam_tpu_torch import cli
    from splatloam_tpu_torch.config import (TrackingMethod,
                                            load_configuration)
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.postprocessing import ResultGraph
    from splatloam_tpu_torch.profiling import get_profiler

    os.chdir(Path(__file__).resolve().parent)   # inherit_from is relative
    cfg = load_configuration(RECON_CFG, list(overrides))
    pc, mc, tc = cfg.preprocessing, cfg.mapping, cfg.tracking
    if not overrides and (
            (pc.image_height, pc.image_width, mc.num_iterations,
             mc.densify_percentage, tc.method, tc.keyframe_threshold_nframes,
             mc.lmodel_threshold_nkeyframes, mc.lmodel_threshold_ngaussians,
             mc.prob_view_last_keyframe) !=
            (128, 1024, 500, 0.4, TrackingMethod.gt, 5, 30, None, None)):
        fail(f"{RECON_CFG} no longer holds the reconstruction settings")
    h, w = pc.image_height, pc.image_width
    rng = np.random.default_rng(SEED)
    poses, clouds = [], []
    for i in range(RECON_SWEEPS):
        pose = np.eye(4)
        pose[0, 3] = RECON_STEP_M * i
        poses.append(pose)
        clouds.append(sensor_raster(rng, RECON_STEP_M * i, h, w,
                                    RECON_FOV_DEG))
    seq, gt = write_kitti_layout(tmp / "recon", poses, clouds)
    out = tmp / "recon" / "results"
    argv = ["slam", RECON_CFG, "--device", dev.type,
            "data.dataset_type=kitti",
            f"data.cloud_reader.cloud_folder={seq}",
            f"data.trajectory_reader.filename={gt}",
            f"output.folder={out}", *overrides]
    n_pts = [len(c) for c in clouds]
    print(f"[recon] {RECON_SWEEPS} sweeps of {h} beams x {w} steps in the "
          f"vertical field of view {RECON_FOV_DEG} deg, {RECON_STEP_M} m "
          f"apart at 10 Hz: {min(n_pts)}-{max(n_pts)} returns each; "
          f"cli.main({argv})", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with ReconProbe() as probe:
        cli.main(argv)
    wall = time.perf_counter() - t
    stats = get_profiler().stats
    update_ms = [1e3 * x for x in stats["map_update"].samples]
    opt_s = stats["map.optimize"].total
    rdir = only_dir(out)
    mesh = mesh_and_score(dev, rdir, "tsdf", RECON_MESH_ARGS, tmp, "recon")
    launches = {k: v.launches for k, v in kernels.KERNELS.items()
                if v.launches}
    peak = torch.cuda.max_memory_allocated()
    mapper, ups = probe.mapper, probe.updates

    iters = sum(u["iters"] for u in ups)
    graph = ResultGraph.from_yaml(rdir / "graph.yaml")
    kf_frames = sorted(round(f.timestamp / 0.1) for f in graph.frames)
    print(f"[recon] slam: {RECON_SWEEPS / wall:.3f} frames/s over the "
          f"command's {wall:.3f} s; keyframes at frames {kf_frames}, "
          f"submaps {len(graph.models)}; keyframe updates "
          f"{[round(x, 3) for x in update_ms]} ms, optimize "
          f"{1e3 * opt_s / iters:.3f} ms/iteration over {iters} iterations",
          flush=True)
    for i, u in enumerate(ups):
        kf = u["k_full"]
        grew = (f", doubled from {u['cap_before']}"
                if u["cap"] != u["cap_before"] else "")
        print(f"[recon] update {i} (frame {kf_frames[i]}): capacity "
              f"{u['cap']}{grew}, {u['active']} active surfels after it, "
              f"{u['iters']} iterations; at its first rebin {kf[0]} of "
              f"{kf[1]} tiles held K = {kf[2]} splats", flush=True)
    k1 = launches.get("K1_fwd", 0)
    densify_renders = sum(1 for i in range(len(ups)) if i)  # all but init
    print(f"[recon] launches over slam + mesh {launches}; iterations "
          f"{iters}, densify renders {densify_renders}, mesh renders "
          f"{mesh['k1']}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated, "
          f"the captured graphs' pools included; "
          f"{RECON_PEAK_UNCAPTURED_GIB} GiB before the port captured); "
          f"captured mapper blocks held at the end "
          f"{graph_stats_line(mapper.graph_stats())}", flush=True)

    if len(ups) != len(kf_frames) or len(update_ms) != len(ups) or \
            len(graph.models) != 1:
        fail(f"{len(ups)} updates, {len(update_ms)} map_update phases and "
             f"{len(graph.models)} submaps for keyframes {kf_frames}")
    if len(ups) < 3 or any(u["iters"] < mc.num_iterations for u in ups):
        fail(f"the run made {len(ups)} updates of "
             f"{[u['iters'] for u in ups]} iterations: fewer than 3 of "
             f"{mc.num_iterations}")
    if not overrides and ups[-1]["cap"] < 131_072:
        fail(f"the last update's pool holds {ups[-1]['cap']} rows, fewer "
             "than 131,072")
    if launches.get("K2_bwd") != iters or \
            launches.get("K3_ranksum") != iters or \
            launches.get("K11_image_loss") != iters:
        fail(f"K2/K3/K11 launched {launches.get('K2_bwd')}/"
             f"{launches.get('K3_ranksum')}/"
             f"{launches.get('K11_image_loss')} times for {iters} "
             "iterations")
    if k1 < iters + densify_renders + mesh["k1"]:
        fail(f"K1 launched {k1} times, fewer than the {iters} iterations, "
             f"{densify_renders} densify renders and {mesh['k1']} mesh "
             "renders")
    t_err, r_err = tum_error(rdir / "odom.txt", poses)
    print(f"[recon] odom.txt (TUM) against GT: max translation error "
          f"{t_err.max():.3e} m, max rotation entry error {r_err.max():.3e} "
          f"(tolerance {RECON_POSE_TOL_M})", flush=True)
    if t_err.max() > RECON_POSE_TOL_M or r_err.max() > RECON_POSE_TOL_M:
        fail("odom.txt is off the GT poses")
    acc = mesh["metrics"]["MAE_accuracy (cm)"]
    if not acc < RECON_ACC_LIMIT_CM:
        fail(f"the mesh's accuracy {acc} cm is not below "
             f"{RECON_ACC_LIMIT_CM} cm")

    # each keyframe re-rendered from the final pool
    for i, kf in enumerate(mapper.model.keyframes):
        check_rerender(mapper, kf, "recon", what=f"keyframe {i}")
    last = mapper.model.keyframes[-1]
    progs = mapper.programs_for(h, w, mapper.model.capacity)
    over = wide_splat_overflow(mapper.model.surfels, last.camera_in_model(),
                               progs.params, cfg.compute.bin_margin_px)
    print(f"[recon] wide splats at keyframe {len(mapper.model.keyframes) - 1}"
          f" of the final pool ({over['alive']} in view of "
          f"{mapper.model.capacity} rows): tier 2 needed by {over['need2']}"
          f", budget {over['k2']}, {over['over2']} beyond it; tier 3 needed "
          f"by {over['need3']}, budget {over['k3']}, {over['over3']} beyond "
          f"it; (tile, splat) pairs listed {over['pairs_sorted']} of the "
          f"{over['pairs_exact']} the exact binner lists", flush=True)
    k = check_recon_kernels(mapper, last, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    m = mesh["metrics"]
    # the CLI logs every frame: repeat the phase's numbers after the logs
    print(f"[recon] summary ({card()}): {RECON_CFG} at {h}x{w}, "
          f"{RECON_SWEEPS} frames, {RECON_SWEEPS / wall:.3f} frames/s, "
          f"updates {[round(x, 1) for x in update_ms]} ms, "
          f"{1e3 * opt_s / iters:.3f} ms/iteration, capacities "
          f"{[u['cap'] for u in ups]}, K-full tiles "
          f"{[u['k_full'][0] for u in ups]}, K1/K2/K3 "
          f"{k1}/{launches.get('K2_bwd')}/{launches.get('K3_ranksum')}, "
          f"peak {peak / 2 ** 30:.3f} GiB; mesh {mesh['wall']:.3f} s "
          f"(renders {[round(x, 3) for x in mesh['render_ms']]} ms, "
          + ", ".join(f"{k_} {v:.3f} s" for k_, v in mesh["steps"].items())
          + f"), eval_recon {mesh['wall_e']:.3f} s: "
          + ", ".join(f"{k_} {v:.4f}" for k_, v in m.items())
          + "; at 2048 tiles "
          + ", ".join(f"{n} {ms:.4f} ms (bound {b:.4f})"
                      for n, (ms, b) in k.items()), flush=True)
    return mapper


def check_rerender(mapper, frame, tag, surf=None, params=None,
                   what: str = "keyframe 1"):
    """The optimized map (``surf`` rendered with ``params``, else the
    mapper's) reproduces the keyframe ``what``'s range image:
    coverage(alpha>0.5) > 0.9 and median depth L1 < 0.25 m.
    -> (coverage, median L1)."""
    from splatloam_tpu_torch.ops.rasterizer.api import render
    if surf is None:
        pkg = mapper.render_frame(frame)
    else:
        cam = frame.camera_in_model()
        with torch.no_grad():
            pkg = render(surf.params.xyz, surf.scaling, surf.rotation,
                         surf.opacity, cam.T_cw, cam.K, params)
    cam = frame.camera
    valid = cam.valid
    l1 = (pkg["surf_depth"] - cam.depth).abs()[valid]
    cover = float((pkg["rend_alpha"][valid] > 0.5).float().mean())
    med_l1 = float(l1.median())
    print(f"[{tag}] {what} re-render: coverage(alpha>0.5) {cover:.4f}, "
          f"median depth L1 {med_l1:.4f} m", flush=True)
    if not (cover > 0.9 and med_l1 < 0.25):
        fail(f"[{tag}] the optimized map does not reproduce {what}")
    return cover, med_l1


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
        out, tb, _ = cuda_raster._forward_tiled(*targs, static)
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


# ---------------------------------------------------------------------------
# phase 9: the compiled programs (graphs.py): captured against uncaptured
# ---------------------------------------------------------------------------

# the captured update against the first uncaptured one, field by field.
# Where the two uncaptured runs agree exactly (no atomics on the path),
# the captured run's largest difference within GRAPH_RTOL of the field's
# largest magnitude.  Where they differ (K4, K5, K6 add by atomics, and
# Adam with eps 1e-15 turns a float-order change into up to a learning
# rate a step, so after 300 steps the runs have parted), the spread is
# one draw of a random distance: the captured run's difference within
# GRAPH_SPREAD x the spread at the 99th percentile of the per-surfel
# difference or at its max (on the H100 one field's 99th percentile
# moved 4.9x between draws while its max held); a scalar (the loss EMA),
# whose one-draw ratio exceeds 3 about one time in five, within
# GRAPH_SPREAD x its spread or GRAPH_SCALAR_RTOL of its value
GRAPH_SPREAD = 3.0
GRAPH_RTOL = 1e-6
GRAPH_SCALAR_RTOL = 1e-2
# (scatter, views_per_iteration) of phase 9's updates
GRAPH_MODES = (("ranksum", 1), ("rmw", 1), ("fused", 1), ("plan", 1),
               ("ranksum", 3))


def update_fields(res) -> dict:
    """An optimize result (surfels, adam, ema, iterations) -> {field:
    tensor [active rows, ...] on the host}."""
    from splatloam_tpu_torch.model import surfels as S
    surf, adam, ema, _ = res
    act = surf.active
    out = {"ema": ema.reshape(1).cpu()}
    for kind, tree in (("", surf.params), ("mu.", adam.mu),
                       ("nu.", adam.nu)):
        for name, a in zip(S.SurfelParams._fields, tree):
            out[kind + name] = a[act].reshape(int(act.sum()), -1).cpu()
    return out


def spread_gate(u1: dict, u2: dict, c: dict) -> dict:
    """{field: (ok, difference, spread)} of a captured result ``c``
    against the first uncaptured one ``u1``, by the spread of the second
    ``u2`` (GRAPH_SPREAD, GRAPH_RTOL): the difference and the spread are
    (max, 99th percentile) of the per-row difference norms."""
    out = {}
    for k in u1:
        d = torch.linalg.norm((c[k] - u1[k]).double(), dim=-1)
        s = torch.linalg.norm((u2[k] - u1[k]).double(), dim=-1)
        scale = float(u1[k].abs().max())
        dd = (float(d.max()), float(torch.quantile(d, 0.99)))
        ss = (float(s.max()), float(torch.quantile(s, 0.99)))
        if ss[0] == 0.0:
            ok = dd[0] <= GRAPH_RTOL * scale
        elif d.numel() == 1:
            ok = dd[0] <= max(GRAPH_SPREAD * ss[0], GRAPH_SCALAR_RTOL * scale)
        else:
            ok = any(a <= GRAPH_SPREAD * b + GRAPH_RTOL * scale
                     for a, b in zip(dd, ss))
        out[k] = (ok, dd, ss)
    return out


def hold_captured(what: str, u1, u2, c) -> None:
    """Fail unless the captured result ``c`` holds to the uncaptured
    ``u1`` by the spread ``u2`` - ``u1``: every field, the active mask and
    the step and iteration counts exactly."""
    if not all(torch.equal(r[0].active, u1[0].active) for r in (u2, c)):
        fail(f"{what}: the active masks differ")
    steps = {int(r[1].step) for r in (u1, u2, c)}
    iters = {int(r[3]) for r in (u1, u2, c)}
    gate = spread_gate(*(update_fields(r) for r in (u1, u2, c)))
    print(f"[graphs] {what}: step {sorted(steps)}, iterations "
          f"{sorted(iters)}, loss EMA {[float(r[2]) for r in (u1, u2, c)]}"
          f" (uncaptured, uncaptured, captured); by field, captured - uncaptured max (p99) / "
          f"the uncaptured spread max (p99): "
          + ", ".join(f"{k} {d[0]:.2e} ({d[1]:.2e}) / {s[0]:.2e} "
                      f"({s[1]:.2e}){'' if ok else ' FAIL'}"
                      for k, (ok, d, s) in gate.items()), flush=True)
    bad = [k for k, (ok, _, _) in gate.items() if not ok]
    if len(steps) != 1 or len(iters) != 1 or bad:
        fail(f"{what}: the captured update is off the uncaptured one "
             f"(steps {steps}, iterations {iters}, fields {bad})")


def graph_stats_line(stats: dict) -> str:
    return "; ".join(
        f"{sig}: captures {s['captures']}, replays {s['replays']}, pool "
        f"{s['pool_bytes'] / 2**20:.1f} MiB, static buffers "
        f"{s['static_bytes'] / 2**20:.1f} MiB" for sig, s in stats.items())


def graphs_update(cfg, model, kf, scatter: str, views: int):
    """Phase 9, one mode: the 300-iteration update from phase 3's pool
    uncaptured twice, captured once (its first update at the signature:
    block 0 uncaptured, the capture, the replays) and captured again
    (the buffers loaded anew, replays only), on one set of keyframe
    draws, each captured update held to the uncaptured ones; the
    launches of each run, one block replayed under
    set_sync_debug_mode("error").  Returns the ms per iteration of each
    path."""
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.slam.mapper import Mapper, MapperPrograms

    cfg_m = copy.deepcopy(cfg)
    cfg_m.compute.scatter = scatter
    cfg_m.mapping.views_per_iteration = views
    progs = MapperPrograms(cfg_m, H, W, model.capacity)
    draw = Mapper(cfg_m, device=model.device, seed=SEED)
    idx = draw._draw_keyframes(kf.probs, progs.n_blocks(),
                               len(model.keyframes) - 1)
    what = f"{scatter}" + (f", views_per_iteration {views}"
                           if views > 1 else "")
    runs, counts, ms = {}, {}, {}
    for name, capture in (("u1", False), ("u2", False), ("c", True),
                          ("c2", True)):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        runs[name] = progs.optimize(model.surfels, model.adam, kf, idx,
                                    capture=capture)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t) * 1e3 / runs[name][3]
        counts[name] = {k: v.launches for k, v in kernels.KERNELS.items()
                        if v.launches}
    hold_captured(what, runs["u1"], runs["u2"], runs["c"])
    hold_captured(f"{what}, captured again (replays from block 0)",
                  runs["u1"], runs["u2"], runs["c2"])
    if not counts["u1"] == counts["u2"] == counts["c"] == counts["c2"]:
        fail(f"{what}: launches captured {counts['c']} (again "
             f"{counts['c2']}), uncaptured {counts['u1']}")
    sig = progs.signature(kf.K.shape[0])
    static, prog = progs._graphs[sig]
    block = idx[0]
    if progs.rebin_outside:
        static.start_block(block)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if not progs.rebin_outside:
            static.start_block(block)
        prog.replay()
    except RuntimeError as e:
        fail(f"{what}: a block replay synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = ("the rebin outside the graph (its boolean-mask plan reads "
             "back to the host), the replay alone" if progs.rebin_outside
             else "the block's keyframe copy and its replay, the rebin "
             "inside the graph")
    print(f"[graphs] {what}: launches equal on both paths {counts['c']}; "
          f"one block under set_sync_debug_mode('error'): {where}, no "
          f"host sync; ms/iteration uncaptured {ms['u1']:.3f} / "
          f"{ms['u2']:.3f}, captured {ms['c']:.3f} (with its capture) / "
          f"{ms['c2']:.3f} (replays); {graph_stats_line(progs.graph_stats())}",
          flush=True)
    if progs.graph_stats()[sig]["replays"] == 0:
        fail(f"{what}: the captured update replayed no block")
    progs.release_graphs()
    return ms


def profile_paths(cfg, model, kf) -> None:
    """Phase 9: two 16-iteration blocks of each path under torch.profiler
    in this call: ms per iteration, device busy ms and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from splatloam_tpu_torch.slam.mapper import MapperPrograms

    cfg = copy.deepcopy(cfg)
    cfg.mapping.num_iterations = 31            # two blocks of 16
    progs = MapperPrograms(cfg, H, W, model.capacity)
    idx = torch.ones((progs.n_blocks(),), dtype=torch.long,
                     device=model.device)
    parts = []
    for name, capture in (("uncaptured", False), ("captured", True),
                          ("captured", True), ("uncaptured", False)):
        progs.optimize(model.surfels, model.adam, kf, idx, capture=capture)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n = progs.optimize(model.surfels, model.adam, kf, idx,
                               capture=capture)[3]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total
                   for e in device_events(prof)) / 1e3
        parts.append(f"{name} {wall / n:.3f} ms/iteration (wall {wall:.3f} "
                     f"ms, device busy {busy:.3f} ms, idle share "
                     f"{1.0 - busy / wall:.4f})")
    progs.release_graphs()
    print(f"[graphs] two blocks of 16 iterations (ranksum) under "
          f"torch.profiler, in turns: {'; '.join(parts)}", flush=True)


def graphs_gn(dev, slam) -> None:
    """Phase 9: one GN solve on phase 4's last frame (its source and its
    keyframe's target) uncaptured twice and captured (warm-up, capture,
    replays), held by the spread rule, each timed; phase 4's own captured
    solves counted."""
    from splatloam_tpu_torch.slam.tracker import (AlignerGN,
                                                  gauss_newton_align)

    seq = slam.tracker.aligner
    print(f"[graphs] phase 4's GN solves: "
          f"{graph_stats_line(seq.graph_stats())}", flush=True)
    if not seq.graph_stats() or \
            min(s["replays"] for s in seq.graph_stats().values()) == 0:
        fail("phase 4's tracker replayed no captured GN solve")
    aligner = AlignerGN(slam.cfg, device=dev)
    aligner._target, aligner._source = seq._target, seq._source
    depth, pts, normals, valid, K, h, w = seq._target
    kw = aligner.solver_settings()
    inputs = (torch.eye(4, device=dev), *seq._source, depth, pts, normals,
              valid, K)
    prog = aligner._program(inputs, h, w)
    prog(*inputs)                        # warm-up and capture

    def solve(fn, reps=20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            T, fit = fn()
            out = torch.cat([T.reshape(-1), fit.reshape(1)]).cpu()
        return out, (time.perf_counter() - t) * 1e3 / reps

    u1, ms_u = solve(lambda: gauss_newton_align(*inputs, h, w, **kw))
    u2, _ = solve(lambda: gauss_newton_align(*inputs, h, w, **kw), 1)
    c, ms_c = solve(lambda: prog(*inputs)[:2])
    gate = spread_gate({"T": u1[None, :16], "fitness": u1[None, 16:]},
                       {"T": u2[None, :16], "fitness": u2[None, 16:]},
                       {"T": c[None, :16], "fitness": c[None, 16:]})
    print(f"[graphs] GN solve ({kw['num_iterations']} iterations, "
          f"{h}x{w}): captured - uncaptured (max) T {gate['T'][1][0]:.3e}, "
          f"fitness {gate['fitness'][1][0]:.3e}, uncaptured spread T "
          f"{gate['T'][2][0]:.3e}, fitness {gate['fitness'][2][0]:.3e}; "
          f"fitness {float(c[16]):.4f}; ms per solve (with its read) "
          f"uncaptured {ms_u:.3f}, captured {ms_c:.3f}; "
          f"{graph_stats_line(aligner.graph_stats())}", flush=True)
    if not all(ok for ok, _, _ in gate.values()):
        fail(f"the captured GN solve is off the uncaptured one: {gate}")


def run_graphs(dev, slice_state, slam) -> None:
    """Phase 9: the compiled programs on phase 3's pool (kitti.yaml,
    64x1024, 300 iterations at rebin 16): each mode's update uncaptured
    twice and captured, two blocks of each path under torch.profiler, and
    a GN solve on phase 4's last frame."""
    cfg, mapper, model, frames = slice_state
    kf = mapper._stack_keyframes(model.kf_stack["K"].shape[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"[graphs] phase 3's pool: {model.no_gaussians} active surfels, "
          f"capacity {model.capacity}; {cfg.mapping.num_iterations} "
          f"iterations at rebin {cfg.compute.rebin_every}", flush=True)
    ms = {}
    for scatter, views in GRAPH_MODES:
        ms[(scatter, views)] = graphs_update(cfg, model, kf, scatter, views)
    profile_paths(cfg, model, kf)
    graphs_gn(dev, slam)
    print(f"[graphs] ms/iteration (uncaptured / captured replays) "
          + ", ".join(f"{s}{'' if v == 1 else ' x3 views'} "
                      f"{m['u1']:.3f} / {m['c2']:.3f}"
                      for (s, v), m in ms.items())
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB", flush=True)


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
    launches, slice_state = run_slice(dev, rng)
    t4 = time.perf_counter()
    poses, clouds, fps, slam4 = run_sequence(dev)
    t5 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rdir, data, fps5 = run_cli(dev, poses, clouds, fps, Path(tmp))
        t6 = time.perf_counter()
        run_mesh(dev, rdir, Path(tmp))
        t7 = time.perf_counter()
        run_parallel(dev, slice_state, data, poses, fps5, Path(tmp))
        t8 = time.perf_counter()
        run_recon(dev, Path(tmp))
    t9 = time.perf_counter()
    run_graphs(dev, slice_state, slam4)
    t10 = time.perf_counter()
    # the host-bound phases 2 to 9 follow the host's pace, which differs
    # between machines
    print(f"[time] build {t1 - t0:.1f} s, phase 1 {t2 - t1:.1f} s, phase 2 "
          f"{t3 - t2:.1f} s, phase 3 {t4 - t3:.1f} s, phase 4 "
          f"{t5 - t4:.1f} s, phase 5 {t6 - t5:.1f} s, phase 6 "
          f"{t7 - t6:.1f} s, phase 7 {t8 - t7:.1f} s, phase 8 "
          f"{t9 - t8:.1f} s, phase 9 {t10 - t9:.1f} s", flush=True)

    line = []
    for name, k in kernels.KERNELS.items():
        line.append(dict(name=name, route="cuda",
                         source=f"splatloam_tpu_torch/csrc/{k.source}",
                         replaces=k.replaces, launches=launches[name],
                         **results[name]))
    print(json.dumps({"kernels": line}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        # one rank of phase 7(b), started by parallel_ranks
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        parallel_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
