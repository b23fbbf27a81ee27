"""Typed configuration tree + YAML loading with inheritance and CLI overrides.

Re-implements the configuration system of the reference
(ref utils/config_utils.py:12-240) without OmegaConf: plain
dataclasses, recursive ``inherit_from`` resolution, dotted-key CLI overrides
(``mapping.num_iterations=200``), and round-trip save.  The YAML schema is kept
compatible with the reference's config files (see configs/).

This is the PyTorch port's own copy of ``splatloam_tpu/config.py``: the
schema and the YAML files are shared, only the rasterizer backends differ
(``cuda`` = tiled hand-written kernels, ``eager`` = golden renderer).
Sections absent in the reference: ``compute`` (backend/capacity/tiling)
and ``parallel`` (mesh axes; ranks over torch.distributed, parallel/).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from enum import Enum
from pathlib import Path
from typing import Any, Optional, get_args, get_origin

import yaml

from .logging_utils import get_logger

logger = get_logger("config")


class TrackingMethod(str, Enum):
    gt = "gt"
    gsaligner = "gsaligner"


class DatasetType(str, Enum):
    generic = "generic"
    vbr = "vbr"
    kitti = "kitti"
    ncd = "ncd"
    oxspires = "oxspires"
    oxspires_vilens = "oxspires_vilens"


class TrajectoryReaderType(str, Enum):
    kitti = "kitti"
    tum = "tum"
    vilens = "vilens"
    null = "null"


class TrajectoryWriterType(str, Enum):
    kitti = "kitti"
    tum = "tum"


class DataLoggerType(str, Enum):
    rerun = "rerun"
    wandb = "wandb"
    tensorboard = "tensorboard"


class PointCloudReaderType(str, Enum):
    bin = "bin"
    ply = "ply"
    pcd = "pcd"
    rosbag = "rosbag"
    null = "null"


class RasterBackend(str, Enum):
    auto = "auto"        # the tiled kernel path ("cuda")
    cuda = "cuda"        # tiled hand-written kernels (plain torch on CPU)
    eager = "eager"      # golden O(N*P) torch renderer


@dataclass
class TrajectoryReaderConfig:
    # mirrors ref utils/config_utils.py:44-60
    reader_type: Optional[TrajectoryReaderType] = None
    filename: Optional[str] = None
    timestamp_dtol: float = 1e-3
    timestamp_from_filename_kitti: Optional[str] = None
    gt_T_sensor_t_xyz_q_xyzw: Optional[tuple] = None
    gt_T_sensor_kitti_filename: Optional[str] = None


@dataclass
class PointCloudReaderConfig:
    # mirrors ref utils/config_utils.py:71-85
    cloud_folder: str = ""
    cloud_format: Optional[PointCloudReaderType] = None
    timestamp_from_filename: Optional[bool] = False
    timestamp_filename: Optional[str] = None
    bin_format: Optional[str] = "<f4"
    rosbag_topic: Optional[str] = None


@dataclass
class AlignerParams:
    """Parameters of the Gauss-Newton scan-to-model aligner.

    Plays the role of the reference's GSAlignerParams (CUDA gsaligner
    submodule, consumed at ref slam/tracker.py:146-158).  The
    image sizes are always overwritten from the preprocessing section.
    """
    image_height: int = 0
    image_width: int = 0
    # Huber robust-kernel scale (meters) on point-to-plane residuals.
    huber_delta: float = 0.3
    # Correspondences farther than this (m) along the residual are rejected.
    max_correspondence_dist: float = 1.0
    # Inlier threshold (m) for the fitness statistic.
    inlier_threshold: float = 0.3
    # Gauss-Newton iterations inside one align() call.
    num_iterations: int = 30
    # Levenberg damping added to the normal equations diagonal.
    damping: float = 1e-6
    # Iteration-scheduled data association: the correspondence gate starts
    # at corr_factor_init * max_correspondence_dist and decays linearly to
    # 1x over corr_decay_iters iterations (wider basin of convergence on
    # aggressive motion, tight association once near the optimum).
    corr_factor_init: float = 3.0
    corr_decay_iters: int = 15
    # Early termination: stop when |dx| (rad+m 6-vector norm) drops below
    # this; 0 disables (fixed num_iterations, round-1 behavior).
    convergence_tol: float = 1e-6
    # Weight of the optional range ("photometric"-analog) residual
    # |T p_s| - rendered_range alongside point-to-plane.  The reference's
    # AlignerGeomPhoto (ref slam/tracker.py:141-197) despite its name
    # receives only depth + points on both sides (set_reference/set_query,
    # ref :160-181) — no intensity channel exists anywhere in its data
    # path — so geometric-only (0.0) IS the reference contract; this term
    # adds the range-image analog of a photometric error for scenes where
    # point-to-plane under-constrains the along-ray translation.
    lambda_range: float = 0.0


@dataclass
class TrackingConfig:
    # mirrors ref utils/config_utils.py:88-95
    num_iterations: int = 10
    method: TrackingMethod = TrackingMethod.gsaligner
    keyframe_threshold_distance: float = 1.0
    keyframe_threshold_nframes: int = -1
    keyframe_threshold_fitness: float = -1.0
    gsaligner: Optional[AlignerParams] = None


@dataclass
class MappingConfig:
    # mirrors ref utils/config_utils.py:98-121
    num_iterations: int = 500
    densify_threshold_egeom: float = -1
    densify_threshold_opacity: float = 0.5
    densify_percentage: float = 0.15
    prob_view_last_keyframe: Optional[float] = 0.4
    pruning_min_opacity: float = 0.0
    pruning_min_size: Optional[float] = 0.0
    pruning_max_size: Optional[float] = 1.0
    early_stop_enable: Optional[bool] = False
    early_stop_patience: Optional[int] = 100
    early_stop_threshold: Optional[float] = 0.01
    opt_lambda_alpha: float = 1e-1
    opt_lambda_normal: float = 1e-1
    opt_scaling_max: float = 0.5
    opt_scaling_max_penalty: float = 0.2
    lmodel_threshold_ngaussians: Optional[int] = 150000
    lmodel_threshold_nkeyframes: Optional[int] = None
    # Extension (no reference counterpart): sample this many keyframes
    # per Adam iteration and average their losses, all views rendered
    # through one launch of each kernel (api.render_batch).  1 = reference
    # semantics (one keyframe per iteration); the sharded programs render
    # one view per iteration.
    views_per_iteration: Optional[int] = 1


@dataclass
class LoggingConfig:
    # mirrors ref utils/config_utils.py:124-137
    enable: bool = True
    logger_type: Optional[DataLoggerType] = DataLoggerType.rerun
    rerun_spawn: Optional[bool] = True
    rerun_serve_grpc: Optional[bool] = None
    rerun_connect_grpc_url: Optional[str] = None
    # render the model at every frame and log estimated depth / normal /
    # depth-L1 images + the transform tree + the input cloud (the
    # reference does this unconditionally, ref slam/slam.py:72-92; it
    # costs one extra forward render per frame, so it is gated here)
    log_renders: Optional[bool] = True
    # sanitizer: assert the active surfel/Adam state is finite after
    # every keyframe map update (device-side reduction + one small D2H;
    # catches a diverged map AT the offending keyframe) — see debug.py
    debug_checks: Optional[bool] = False


@dataclass
class DatasetConfig:
    # mirrors ref utils/config_utils.py:140-149
    dataset_type: DatasetType = DatasetType.generic
    trajectory_reader: Optional[TrajectoryReaderConfig] = field(
        default_factory=TrajectoryReaderConfig)
    cloud_reader: Optional[PointCloudReaderConfig] = field(
        default_factory=PointCloudReaderConfig)
    skip_clouds_wno_sync: Optional[bool] = False


@dataclass
class OutputConfig:
    # mirrors ref utils/config_utils.py:152-157
    folder: Optional[str] = None
    writer: TrajectoryWriterType = TrajectoryWriterType.tum
    # Mid-run snapshot for preemption-safe resume (new).
    checkpoint_dir: Optional[str] = None
    checkpoint_every_keyframes: Optional[int] = None


@dataclass
class PreprocessingConfig:
    # mirrors ref utils/config_utils.py:160-175
    image_height: int = 0
    image_width: int = 0
    depth_min: float = 0.0
    depth_max: float = 1e6
    enable_normal_estimation: Optional[bool] = True
    enable_ground_segmentation: Optional[bool] = True


@dataclass
class OptimizationConfig:
    # mirrors ref utils/config_utils.py:178-188
    position_lr: float = 0.0005
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    # 0 -> expected depth, 1 -> median depth
    depth_ratio: float = 0


@dataclass
class ComputeConfig:
    """Compute knobs (new; the reference hardcodes cuda:0)."""
    backend: RasterBackend = RasterBackend.auto
    # Initial surfel pool capacity; grows by doubling.
    initial_capacity: int = 32768
    # Keyframe-slot bucket per submap (the keyframe stack grows by it).
    keyframe_capacity: int = 32
    # Rasterizer tile size (rows, cols), used when auto_tile is off.
    tile_h: int = 4
    tile_w: int = 16
    # Per-tile surfel list capacity (depth-ordered; overflow drops farthest).
    tile_list_capacity: int = 768
    # Chunk of surfels composited per kernel step.
    chunk: int = 256
    # Max anisotropic splat radius in multiples of sigma used for tile binning.
    sigma_cut: float = 3.0
    # Rebuild tile lists every N mapping iterations (1 = exact per-step
    # binning); the sampled keyframe is held fixed within a block.
    rebin_every: int = 16
    # Binning radius margin (pixels) absorbing parameter drift between
    # rebinning points.
    bin_margin_px: float = 1.5
    # Gradient reduction: "ranksum" (rebin-time id-sort + segmented sum
    # kernel), "rmw" (atomic scatter-add kernel), "plan" (rebin-time
    # occurrence tables: gather-sum + overflow scatter kernel) or "fused"
    # (the scatter-add inside the backward kernel); all exact up to
    # float summation order.  The ranksum and occurrence plans cost one
    # argsort per rebin point, so rebin_every=1 callers prefer "rmw" or
    # "fused".
    scatter: str = "ranksum"
    # Pick tile/chunk geometry from the live pool capacity instead of
    # the fields above (ops/rasterizer/api.adaptive_geometry).
    auto_tile: bool = True
    # Sharded mapping: all-gather the non-position parameters in float16
    # (row bytes 40 -> 26 on the "model" axis, parallel/sharded.py).
    compact_param_comms: bool = False


@dataclass
class ParallelConfig:
    """Device-mesh layout (new; the reference is single-device)."""
    # Number of ways the range-image tile grid is sharded (data/sequence axis).
    data: int = 1
    # Number of ways the surfel pool is sharded (FSDP-style model axis).
    model: int = 1
    # Work split of the sharded mapper (parallel/sharded.py): "rows"
    # (row blocks over "data"), "tiles" (count-balanced tiles over "data",
    # cuda backend), "ring" (depth bands over "model" with ring
    # compositing, cuda backend) or "auto" ("tiles" on cuda, "rows" on
    # eager).  data*model > 1 needs that many torch.distributed ranks
    # (torchrun).
    partition: str = "auto"


@dataclass
class Configuration:
    # mirrors ref utils/config_utils.py:192-202 (+ compute/parallel)
    inherit_from: Optional[str] = None
    data: DatasetConfig = field(default_factory=DatasetConfig)
    preprocessing: PreprocessingConfig = field(
        default_factory=PreprocessingConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    opt: OptimizationConfig = field(default_factory=OptimizationConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # Kept for config-file compatibility with the reference; the port's
    # entry points take an explicit ``device`` argument instead.
    device: str = "cuda"


# ---------------------------------------------------------------------------
# Structured conversion: nested dict <-> dataclass tree
# ---------------------------------------------------------------------------

def _unwrap_optional(tp):
    if get_origin(tp) is not None and type(None) in get_args(tp):
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(tp, value):
    """Coerce a YAML-loaded value into the annotated type."""
    if value is None:
        return None
    tp = _unwrap_optional(tp)
    if is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if isinstance(value, dict):
            return _from_dict(tp, value)
        raise TypeError(f"cannot build {tp} from {value!r}")
    if isinstance(tp, type) and issubclass(tp, Enum):
        return tp(value)
    if tp is float:
        return float(value)
    if tp is int:
        # YAML may parse "150000" fine but floats like 1.5e5 need the cast.
        return int(value)
    if tp is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if tp is str:
        return str(value)
    return value


def _from_dict(cls, data: dict):
    kwargs = {}
    known = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key not in known:
            logger.warning(f"unknown config key '{key}' for {cls.__name__}; "
                           "keeping it unvalidated")
            continue
        kwargs[key] = _coerce(_resolve_type(cls, known[key]), value)
    return cls(**kwargs)


def from_dict(cls, data: dict):
    """Public structured constructor: nested dict -> dataclass tree."""
    return _from_dict(cls, data)


_TYPE_CACHE: dict = {}


def _resolve_type(cls, f):
    key = (cls, f.name)
    if key not in _TYPE_CACHE:
        import typing
        hints = typing.get_type_hints(cls)
        for ff in fields(cls):
            _TYPE_CACHE[(cls, ff.name)] = hints[ff.name]
    return _TYPE_CACHE[key]


def to_dict(obj) -> Any:
    """Dataclass tree -> plain-python tree (Enums to their values)."""
    if is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_dotlist(args: list[str]) -> dict:
    """['a.b=1', 'c=x'] -> nested dict with YAML-parsed scalar values."""
    out: dict = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"CLI override '{arg}' is not of form key=value")
        key, _, raw = arg.partition("=")
        value = yaml.safe_load(raw) if raw != "" else None
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def load_configuration(filename: str | Path,
                       cli_args: Optional[list[str]] = None) -> Configuration:
    """Load a YAML config with recursive ``inherit_from`` + CLI overrides.

    Mirrors ref utils/config_utils.py:205-233.  ``inherit_from``
    paths are resolved first relative to the current working directory and
    then relative to the including file's directory.
    """
    merged = _load_dict_recursive(Path(filename))
    if cli_args:
        merged = _deep_merge(merged, _parse_dotlist(list(cli_args)))
    return _from_dict(Configuration, merged)


def _load_dict_recursive(filename: Path) -> dict:
    with open(filename) as f:
        data = yaml.safe_load(f) or {}
    parent = data.get("inherit_from")
    if parent is not None:
        parent_path = Path(parent)
        if not parent_path.is_file():
            candidate = filename.parent / parent
            if candidate.is_file():
                parent_path = candidate
        logger.debug(f"inheriting configuration from {parent_path}")
        base = _load_dict_recursive(parent_path)
        data = _deep_merge(base, data)
    return data


def save_configuration(filename: str | Path, configuration) -> None:
    """Round-trip-safe YAML save (ref utils/config_utils.py:236-240)."""
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    payload = to_dict(configuration)
    with open(filename, "w") as f:
        yaml.safe_dump(payload, f, sort_keys=False)
    with open(filename) as f:
        reread = yaml.safe_load(f)
    assert reread == payload, "configuration round-trip mismatch"
