"""Command-line interface of the port: slam / mesh / eval_odom /
eval_recon / crop_recon / generate_dummy_cfg.

The port's counterpart of splatloam_tpu/cli.py (argparse; dotted
overrides such as ``mapping.num_iterations=200`` go to the config merge
as there).  ``slam``, its supervised child and ``mesh`` run on
``--device`` (``cuda`` or ``cpu``); without it they run on cuda and raise
when no GPU is present.  The config's ``device:`` field is ignored, so no
YAML moves a run onto the CPU.  ``eval_odom``, ``eval_recon`` and
``crop_recon`` are host code (numpy, scipy) and take no device; their
CSVs are written with the ``csv`` module, in the columns of the JAX CLI's
pandas CSVs.

The JAX CLI's persistent XLA compilation cache (``_enable_compilation_cache``)
has no counterpart: the kernels are built once per checkout into
``build/splatloam_tpu_torch`` (ops/rasterizer/kernels.py) and loaded from
there by every later run.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from datetime import datetime
from pathlib import Path

import numpy as np

from .config import (Configuration, TrackingMethod, TrajectoryReaderConfig,
                     TrajectoryReaderType, load_configuration,
                     save_configuration)
from .logging_utils import get_logger, set_log_level

logger = get_logger("main")


def safe_state(seed: int = 0) -> None:
    """Deterministic seeding (ref utils/general_utils.py:7-9)."""
    import random
    random.seed(seed)
    np.random.seed(seed)


def pipeline_sanity_check(cfg, data_loader) -> None:
    """Pre-run consistency asserts (ref run.py:406-430)."""
    from .io.trajectory import TrajectoryReader_NULL
    if cfg.tracking.method == TrackingMethod.gt and \
            isinstance(data_loader.traj_reader, TrajectoryReader_NULL):
        logger.error("Tracking method is gt but trajectory reader is NULL. "
                     "Verify input trajectory file.")
        sys.exit(-1)
    if cfg.tracking.method == TrackingMethod.gt and \
            not cfg.data.skip_clouds_wno_sync:
        logger.error("Tracking method is gt but data.skip_clouds_wno_sync "
                     "is False. Aborting to avoid integrating wrong "
                     "measurements.")
        sys.exit(-1)


def run_supervised(args, extra: list[str]) -> None:
    """Elastic recovery: run `slam` as a child process and restart it from
    the latest checkpoint when it dies (preemption, OOM, injected fault).
    The restart budget refills whenever the checkpoint advances, so long
    runs survive many preemptions while genuine crash loops (no forward
    progress) still terminate.  The child is ``python -m
    splatloam_tpu_torch slam ... --resume`` on the supervisor's device,
    with this package first on its PYTHONPATH.
    """
    import subprocess

    cfg = load_configuration(args.configuration, extra)
    ckpt_dir = cfg.output.checkpoint_dir
    if not ckpt_dir:
        logger.warning("supervise: output.checkpoint_dir unset — restarts "
                       "will replay from frame 0")

    def progress() -> int:
        if not ckpt_dir:
            return 0
        manifest = Path(ckpt_dir) / "manifest.json"
        if not manifest.is_file():
            return 0
        try:
            with open(manifest) as f:
                return int(json.load(f).get("n_frames_processed", 0))
        except (OSError, ValueError):
            return 0

    child_argv = [sys.executable, "-m", "splatloam_tpu_torch", "slam",
                  str(args.configuration), "--resume"]
    if args.verbose:
        child_argv.append("--verbose")
    if args.max_frames is not None:
        child_argv += ["--max-frames", str(args.max_frames)]
    if args.device is not None:
        child_argv += ["--device", args.device]
    if args.debug_checks is not None:
        child_argv += ["--debug-checks", args.debug_checks]
    child_argv += extra
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)

    budget = args.max_restarts
    attempt = 0
    while True:
        attempt += 1
        before = progress()
        logger.info(f"supervise: attempt {attempt} "
                    f"(checkpoint at frame {before}, "
                    f"{budget} restarts left)")
        rc = subprocess.call(child_argv, env=env)
        if rc == 0:
            logger.info("supervise: run completed")
            return
        after = progress()
        if after > before:
            budget = args.max_restarts      # forward progress: refill
        else:
            budget -= 1
        logger.warning(f"supervise: child exited rc={rc} at frame "
                       f"{after}; {'restarting' if budget > 0 else 'giving up'}")
        if budget <= 0:
            sys.exit(rc)


def _join_ranks(device):
    """Under torchrun (``WORLD_SIZE`` > 1): join the process group and
    return (this rank's device, True), ``cuda:LOCAL_RANK`` (``cuda:0`` for ranks
    that share one GPU).  On the GPU the first local rank builds the
    kernels before the others pass the barrier, so no two ranks run nvcc
    on the same sources."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device, False
    import torch
    from .parallel.mesh import initialize_distributed, local_rank, rank_device
    device = rank_device(device.type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(device=device)
    if device.type == "cuda":
        import torch.distributed as dist
        if local_rank() == 0:
            from .ops.rasterizer import kernels
            kernels.build_all()
        dist.barrier()
    return device, True


def cmd_slam(args, extra: list[str]) -> None:
    if args.supervise:
        return run_supervised(args, extra)
    from .device import resolve_device
    device, joined = _join_ranks(resolve_device(args.device))
    safe_state()
    set_log_level(args.verbose)
    if args.debug_checks:
        from .debug import enable_checks
        enable_checks(args.debug_checks)
    cfg = load_configuration(args.configuration, extra)
    logger.info(f"Running experiment with configuration: {cfg}")

    from .io.datasets import get_dataset_reader
    from .logging_backends import reset_datalogger
    from .preprocessing import Preprocessor
    from .profiling import get_profiler, reset_profiler
    from .slam import SLAM
    reset_datalogger()          # built from this run's configuration
    reset_profiler()            # the phase profile of this run alone
    data_loader = get_dataset_reader(cfg)
    preprocessor = Preprocessor(cfg, device=device)
    slam_module = SLAM(cfg, device=device)
    pipeline_sanity_check(cfg, data_loader)

    skip = 0
    # a fault before the first checkpoint leaves the directory with the
    # fault sentinel only: such a run restarts from frame 0
    if args.resume and cfg.output.checkpoint_dir and \
            (Path(cfg.output.checkpoint_dir) / "manifest.json").is_file():
        from .checkpoint import load_checkpoint
        skip = load_checkpoint(cfg.output.checkpoint_dir, slam_module)

    iterator = data_loader
    if slam_module.writes:
        try:
            from rich.progress import track
            iterator = track(data_loader, description="Processing frames")
        except Exception:
            iterator = data_loader
    n = args.max_frames
    fault_at = os.environ.get("SPLATLOAM_FAULT_AT_FRAME")
    for i, (cloud, timestamp, pose) in enumerate(iterator):
        if i < skip:
            continue
        if n is not None and i >= n:
            break
        if fault_at is not None and i == int(fault_at):
            # fault injection for elastic-recovery tests: dies once (a
            # sentinel in the checkpoint dir suppresses re-injection
            # after the supervisor restarts us), like a preemption
            sentinel = (Path(cfg.output.checkpoint_dir) / ".fault_injected"
                        if cfg.output.checkpoint_dir else None)
            if sentinel is None or not sentinel.exists():
                if sentinel is not None:
                    sentinel.parent.mkdir(parents=True, exist_ok=True)
                    sentinel.touch()
                raise RuntimeError(
                    f"injected fault at frame {i} "
                    "(SPLATLOAM_FAULT_AT_FRAME)")
        # each call records its phase, "preprocess" and "process"
        slam_module.process(preprocessor(cloud, timestamp, pose))

    logger.info("phase profile:\n" + get_profiler().report())
    results_dir = slam_module.save_results()
    if joined:
        import torch.distributed as dist
        dist.destroy_process_group()
    if results_dir is None:     # a rank other than 0 writes nothing
        return
    print(f"Completed! Results in {results_dir}\n"
          f"  mesh:      python -m splatloam_tpu_torch mesh {results_dir}\n"
          f"  eval odom: python -m splatloam_tpu_torch eval_odom "
          f"{results_dir}")


def cmd_mesh(args, extra) -> None:
    from .device import resolve_device
    device = resolve_device(args.device)
    safe_state()
    set_log_level(args.verbose)
    from .eval.tsdf import save_mesh_ply
    from .postprocessing import ResultGraph, mesh_poisson, mesh_tsdf
    from .profiling import get_profiler, reset_profiler
    reset_profiler()            # the phase profile of this run alone

    input_path = Path(args.input)
    if input_path.is_dir():
        graph_filename, graph_dir = input_path / "graph.yaml", input_path
    else:
        graph_filename, graph_dir = input_path, input_path.parent
    graph = ResultGraph.from_yaml(graph_filename)
    logger.info(f"Loaded {graph}")
    cfg = load_configuration(graph_dir / "cfg.yaml")

    if args.output is None:
        mesh_dir = graph_dir / "meshes"
        mesh_dir.mkdir(parents=True, exist_ok=True)
        date = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        output = mesh_dir / (date + ".ply")
    else:
        output = Path(args.output)
        output.parent.mkdir(parents=True, exist_ok=True)

    if args.method == "poisson":
        verts, faces = mesh_poisson(
            graph, cfg, graph_dir, kf_interval=args.kf_interval,
            kf_samples=args.kf_samples, min_opacity=args.min_opacity,
            poisson_depth=args.poisson_depth,
            poisson_width=args.poisson_width,
            poisson_min_density=args.poisson_density_min,
            screen_voxels=args.poisson_screen,
            max_depth_dist=args.max_depth_dist,
            use_median_depth=args.median_depth, device=device)
    else:
        verts, faces = mesh_tsdf(
            graph, cfg, graph_dir, voxel_size=args.voxel_size,
            trunc=args.trunc, kf_interval=args.kf_interval,
            kf_samples=args.kf_samples, min_opacity=args.min_opacity,
            max_depth_dist=args.max_depth_dist,
            use_median_depth=args.median_depth, device=device)
    save_mesh_ply(output, verts, faces)
    logger.info("phase profile:\n" + get_profiler().report())
    logger.info(f"Saved mesh at {output}")


def cmd_eval_odom(args, extra) -> None:
    safe_state()
    set_log_level(args.verbose)
    from .eval.odometry import evaluate_rpe
    from .io.datasets import get_dataset_reader
    from .io.trajectory import (TrajectoryReader_KITTI,
                                trajectory_reader_available)

    estimate_filename = Path(args.estimate)
    if estimate_filename.is_dir():
        estimate_dir = estimate_filename
        estimate_filename = estimate_dir / "odom.txt"
    else:
        estimate_dir = estimate_filename.parent

    cfg_filename = Path(args.cfg) if args.cfg else estimate_dir / "cfg.yaml"
    treader_estimate = treader_reference = None
    reference_filename = args.reference
    if cfg_filename.is_file():
        cfg = load_configuration(cfg_filename)
        treader_reference = get_dataset_reader(cfg).traj_reader
        est_tcfg = TrajectoryReaderConfig(
            reader_type=TrajectoryReaderType(cfg.output.writer.value),
            filename=str(estimate_filename))
        treader_estimate = trajectory_reader_available[
            est_tcfg.reader_type](est_tcfg)
        reference_filename = cfg.data.trajectory_reader.filename
    if args.estimate_format:
        treader_estimate = trajectory_reader_available[
            TrajectoryReaderType(args.estimate_format)](
            TrajectoryReaderConfig(
                filename=str(estimate_filename),
                timestamp_from_filename_kitti=args.kitti_timestamps))
    if reference_filename and args.reference_format:
        treader_reference = trajectory_reader_available[
            TrajectoryReaderType(args.reference_format)](
            TrajectoryReaderConfig(
                filename=str(reference_filename),
                timestamp_from_filename_kitti=args.kitti_timestamps))
    if treader_reference is None or treader_estimate is None:
        raise RuntimeError("could not instantiate trajectory readers; pass "
                           "--reference/--reference-format")

    n_est, n_ref = len(treader_estimate.poses), len(treader_reference.poses)
    if n_est != n_ref:
        logger.warning(f"No. estimated poses ({n_est}) differs from "
                       f"reference ({n_ref})")
        if isinstance(treader_reference, TrajectoryReader_KITTI):
            logger.error("stopping: reference is in KITTI (index-aligned) "
                         "format")
            sys.exit(-1)
    is_kitti = isinstance(treader_reference, TrajectoryReader_KITTI)
    # parity: the reference evaluates against the RAW reference poses
    # (gt_T_sensor is applied when feeding SLAM, not during evaluation —
    # ref run.py:274-277)
    mean, std = evaluate_rpe(
        estimated_trajectory=list(treader_estimate.poses),
        gt_trajectory=list(treader_reference.poses),
        timestamps=list(treader_estimate.timestamps),
        gt_timestamps=list(treader_reference.timestamps),
        is_kitti=is_kitti)
    res = {"estimate": str(estimate_filename),
           "reference": str(reference_filename),
           "rpe-mean": mean, "rpe-stdev": std}
    logger.info(res)
    if args.save:
        out = args.output or (estimate_dir / "evaluation_rpe.csv")
        _write_csv_row(out, res)
        logger.info(f"Saved results in {out}")
    print(f"TLDR: RPE={mean:.5f} +- {std:.5f}")


def _write_csv_row(filename, row: dict) -> None:
    """One-row CSV with the columns and values of the JAX CLI's pandas
    CSV (``DataFrame(row, index=[0]).to_csv(index=False)``)."""
    with open(filename, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row))
        writer.writeheader()
        writer.writerow(row)


def cmd_eval_recon(args, extra) -> None:
    safe_state()
    set_log_level(args.verbose)
    from .eval.recon import evaluate_recon
    metrics = evaluate_recon(
        Path(args.reference), Path(args.estimate),
        down_sample_res=args.down_sample_res, threshold=args.threshold,
        truncation_acc=args.truncation_acc,
        truncation_com=args.truncation_com,
        gt_bbox_mask_on=args.gt_bbox_mask,
        mesh_sample_point=args.mesh_sample_point,
        generate_error_map=args.generate_error_map)
    row = {"mesh": Path(args.estimate).stem, "threshold": args.threshold,
           "truncation_acc": args.truncation_acc, **metrics}
    logger.info(row)
    if args.save:
        out = args.output or \
            f"eval_recon_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}.csv"
        _write_csv_row(out, row)
    print(f"TLDR: Acc={metrics['MAE_accuracy (cm)']:.3f} "
          f"Com={metrics['MAE_completeness (cm)']:.3f} "
          f"C-L1={metrics['Chamfer_L1 (cm)']:.3f} "
          f"F-score={metrics['F-score (%)']:.3f}")


def cmd_crop_recon(args, extra) -> None:
    safe_state()
    set_log_level(args.verbose)
    from .eval.recon import crop_union
    from .io.ply import write_ply
    cropped = crop_union(Path(args.reference),
                         [Path(p) for p in args.estimates],
                         threshold_dist=args.threshold_dist,
                         mesh_sample_point=args.mesh_sample_point)
    out = args.output or \
        f"{Path(args.reference).stem}_crop_" \
        f"{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}.ply"
    write_ply(out, {"x": cropped[:, 0], "y": cropped[:, 1],
                    "z": cropped[:, 2]})
    print(f"Cropping complete -> {out}")


def cmd_generate_dummy_cfg(args, extra) -> None:
    cfg = Configuration()
    save_configuration(args.output, cfg)
    logger.info(f"Saved default config at {args.output}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="splatloam_tpu_torch",
        description="Gaussian-surfel LiDAR odometry & mapping "
                    "(PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("slam", help="Run SLAM over a configuration; extra "
                       "args of form a.b=c override config values")
    s.add_argument("configuration", type=Path)
    s.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the run goes (default cuda; raises without "
                        "a GPU); the config's device field is ignored")
    s.add_argument("--verbose", "-v", action="store_true")
    s.add_argument("--max-frames", type=int, default=None)
    s.add_argument("--resume", action="store_true",
                   help="resume from output.checkpoint_dir if present")
    s.add_argument("--supervise", action="store_true",
                   help="elastic recovery: restart from the latest "
                        "checkpoint on crash/preemption")
    s.add_argument("--debug-checks", choices=["nans", "infs", "all"],
                   default=None,
                   help="autograd anomaly mode and NaN/Inf checks of every "
                        "render (slow; see splatloam_tpu_torch.debug; "
                        "combine with logging.debug_checks=true for "
                        "per-keyframe state finiteness asserts)")
    s.add_argument("--max-restarts", type=int, default=5,
                   help="restarts without checkpoint progress before "
                        "giving up (budget refills on progress)")
    s.set_defaults(func=cmd_slam)

    m = sub.add_parser("mesh", help="Extract a mesh from SLAM output")
    m.add_argument("input", help="result folder or graph.yaml")
    m.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the keyframe renders and the TSDF fusion "
                        "run (default cuda; raises without a GPU)")
    m.add_argument("--output", "-o", default=None)
    m.add_argument("--method", choices=["tsdf", "poisson"], default="tsdf")
    m.add_argument("--voxel-size", type=float, default=0.1)
    m.add_argument("--trunc", type=float, default=0.3)
    m.add_argument("--poisson-depth", "-d", type=int, default=10)
    m.add_argument("--poisson-width", "-w", type=float, default=None)
    m.add_argument("--poisson-density-min", "-m", type=float, default=0.01)
    m.add_argument("--poisson-screen", type=float, default=0.0,
                   help="screened-Poisson decay length in voxels for the "
                        "grid solver (0 = unscreened); Open3D's octree "
                        "solver screens natively")
    m.add_argument("--kf-interval", "-i", type=int, default=-1)
    m.add_argument("--kf-samples", "-n", type=int, default=5000)
    m.add_argument("--min-opacity", type=float, default=0.5)
    m.add_argument("--max-depth-dist", "-D", type=float, default=0.1)
    m.add_argument("--median-depth", action="store_true")
    m.add_argument("--verbose", "-v", action="store_true")
    m.set_defaults(func=cmd_mesh)

    e = sub.add_parser("eval_odom", help="Evaluate trajectory RPE")
    e.add_argument("estimate")
    e.add_argument("--reference", default=None)
    e.add_argument("--estimate-format", default=None)
    e.add_argument("--reference-format", default=None)
    e.add_argument("--cfg", default=None)
    e.add_argument("--kitti-timestamps", default=None)
    e.add_argument("--output", default=None)
    e.add_argument("--save", action="store_true", default=True)
    e.add_argument("--verbose", "-v", action="store_true")
    e.set_defaults(func=cmd_eval_odom)

    r = sub.add_parser("eval_recon", help="Evaluate reconstruction metrics")
    r.add_argument("reference")
    r.add_argument("estimate")
    r.add_argument("--output", default=None)
    r.add_argument("--down-sample-res", type=float, default=0.02)
    r.add_argument("--threshold", type=float, default=0.2)
    r.add_argument("--truncation-acc", type=float, default=0.5)
    r.add_argument("--truncation-com", type=float, default=0.5)
    r.add_argument("--gt-bbox-mask", action="store_true", default=True)
    r.add_argument("--mesh-sample-point", type=int, default=10_000_000)
    r.add_argument("--generate-error-map", action="store_true",
                   help="write a heat-colored accuracy-error PLY next to "
                        "the estimate (stubbed NotImplementedError in the "
                        "reference)")
    r.add_argument("--save", action="store_true", default=True)
    r.add_argument("--verbose", "-v", action="store_true")
    r.set_defaults(func=cmd_eval_recon)

    c = sub.add_parser("crop_recon", help="Crop reference cloud to the "
                       "union of estimate meshes")
    c.add_argument("reference")
    c.add_argument("estimates", nargs="+")
    c.add_argument("--output", default=None)
    c.add_argument("--threshold-dist", type=float, default=1.2)
    c.add_argument("--mesh-sample-point", type=int, default=10_000_000)
    c.add_argument("--verbose", "-v", action="store_true")
    c.set_defaults(func=cmd_crop_recon)

    g = sub.add_parser("generate_dummy_cfg",
                       help="Write a default config file")
    g.add_argument("output", type=Path)
    g.set_defaults(func=cmd_generate_dummy_cfg)
    return p


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    # dotted-key overrides (a.b=c) are routed to the config merge
    extra = [a for a in argv if "=" in a and not a.startswith("-")]
    argv = [a for a in argv if a not in extra]
    args = build_parser().parse_args(argv)
    args.func(args, extra)


if __name__ == "__main__":
    main()
