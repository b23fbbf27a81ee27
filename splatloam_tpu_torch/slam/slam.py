"""SLAM orchestrator: the per-frame protocol and the results writer.

Counterpart of splatloam_tpu/slam/slam.py: init on frame 0, track,
keyframe / submap-rollover decisions, odometry accumulation
wTf = wTm @ mTkf @ kfTf (on the host, float64), per-frame data logging,
and the results artifact contract (cfg.yaml / odom.txt / graph.yaml /
models/*.ply).

With ``parallel.data * parallel.model`` > 1 every rank runs the same
frames (the mapper's collectives need all of them), and whatever a rank
decides from a float must be the same on every rank, or the next
collective deadlocks: the tracked pose and the keyframe decision come
from rank 0 by broadcast (the mapper's draws too), and the pool every
rank holds between updates is the same gathered one.  Only rank 0
writes results, checkpoints and logger output.
"""
from __future__ import annotations

from datetime import datetime
from pathlib import Path

import numpy as np

from ..config import (Configuration, TrajectoryWriterType,
                      save_configuration)
from ..device import resolve_device
from ..io import ply as plyio
from ..io.trajectory import trajectory_writer_available
from ..logging_backends import DataLoggerDummy, get_datalogger
from ..logging_utils import get_logger
from ..model import surfels as S
from ..model.frame import Frame
from ..model.local_model import LocalModel
from ..postprocessing import ResultGraph
from ..profiling import get_profiler
from .mapper import Mapper
from .tracker import Tracker

logger = get_logger("slam")


class SLAM:
    """``device``: None -> cuda (raises without a GPU).  ``seed`` seeds the
    mapper's random draws."""

    def __init__(self, cfg: Configuration, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mapper = Mapper(cfg, device=self.device, seed=seed)
        self.tracker = Tracker(cfg, device=self.device)
        self.local_models: list[LocalModel] = []
        self.frames: list[Frame] = []
        self.date_start = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.world_T_odom: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self._keyframes_since_ckpt = 0

    @property
    def writes(self) -> bool:
        """Whether this process writes results and logs (rank 0 only)."""
        return self.mapper.writes

    def _dlog(self):
        return get_datalogger(self.cfg) if self.writes else DataLoggerDummy()

    def _agree_on_tracking(self, frame: Frame, new_keyframe: bool) -> bool:
        """Under a mesh: rank 0's tracked pose and keyframe decision on
        every rank."""
        mesh = self.mapper.mesh
        if mesh is None:
            return new_keyframe
        import torch
        from ..parallel import collectives
        buf = torch.zeros((17,), dtype=torch.float64, device=mesh.device)
        buf[:16] = torch.as_tensor(self.tracker.keyframe_T_frame,
                                   dtype=torch.float64).reshape(-1)
        buf[16] = float(new_keyframe)
        buf = collectives.broadcast_(buf, mesh.group("world")).cpu().numpy()
        self.tracker.keyframe_T_frame = buf[:16].reshape(4, 4)
        frame.model_T_frame = (self.local_models[-1].keyframes[-1]
                               .model_T_frame @ self.tracker.keyframe_T_frame)
        return bool(buf[16])

    def _current_odometry(self) -> np.ndarray:
        wTm = self.local_models[-1].world_T_model
        mTkf = self.local_models[-1].keyframes[-1].model_T_frame
        kfTf = self.tracker.keyframe_T_frame
        return wTm @ mTkf @ kfTf

    def process(self, frame: Frame) -> None:
        """Per-frame protocol."""
        with get_profiler().phase("process"):
            dlog = self._dlog()
            dlog.set_timestamp(frame.timestamp)

            if len(self.frames) == 0:
                # the first frame anchors the map at its GT pose
                frame.model_T_frame = frame.world_T_frame.copy()
                self.initialize_new_local_model(frame)
                self.frames.append(frame)
                self.world_T_odom.append(self._current_odometry())
                self.timestamps.append(frame.timestamp)
                return

            with get_profiler().phase("track"):
                self.tracker.track(frame)

            if self._agree_on_tracking(frame,
                                       self.tracker.require_new_keyframe()):
                logger.debug("New keyframe required")
                if self.local_models[-1].require_new_model():
                    self.initialize_new_local_model(frame)
                else:
                    self.insert_new_keyframe(frame)
                self._maybe_checkpoint()

            self.frames.append(frame)
            wTf = self._current_odometry()
            self.world_T_odom.append(wTf)
            self.timestamps.append(frame.timestamp)
            logger.info(f"t={frame.timestamp} | pos={wTf[:3, -1]}")
            self._log_frame(frame, dlog)
            if self.local_models[-1].keyframes[-1] is not frame:
                # nothing reads a processed sweep's normal map again (the
                # tracker and the mapper read the keyframes'): 1.5 MB of
                # device memory a 128x1024 sweep that ``frames`` would
                # otherwise hold for the whole run
                frame.camera = frame.camera._replace(normal=None)

    def _log_frame(self, frame: Frame, dlog) -> None:
        """Per-frame observability: transform tree, input cloud, rendered
        depth/normal/depth-L1 images."""
        if not self.cfg.logging.enable or not self.writes:
            return
        with get_profiler().phase("log_frame"):
            lmodel = self.local_models[-1]
            dlog.log_transform("world/model", lmodel.world_T_model)
            dlog.log_transform("world/model/keyframe",
                               lmodel.keyframes[-1].model_T_frame)
            dlog.log_transform("world/model/keyframe/frame",
                               self.tracker.keyframe_T_frame)
            cam = frame.camera
            gt_depth = cam.depth.cpu().numpy()
            dlog.log_depth_image("frame/depth_in", gt_depth)
            if not self.cfg.logging.log_renders:
                return
            from ..geometry import spherical
            pts = spherical.depth_to_points(cam.depth, cam.K).cpu().numpy()
            valid = cam.valid.cpu().numpy()
            dlog.log_pointcloud("world/model/keyframe/frame",
                                pts[valid].reshape(-1, 3))
            pkg = self.mapper.render_frame(frame)
            est_depth = pkg["surf_depth"].cpu().numpy()
            depth_l1 = np.abs(est_depth - gt_depth)
            depth_l1[~valid] = 0.0
            est_normal = pkg["rend_normal"].cpu().numpy() * 0.5 + 0.5
            dlog.log_image("frame/normals", est_normal)
            dlog.log_depth_image("frame/depth", est_depth)
            dlog.log_depth_image("frame/depth_l1", depth_l1)

    def insert_new_keyframe(self, frame: Frame) -> None:
        logger.info("Inserting new keyframe")
        self.local_models[-1].insert_keyframe(frame)
        with get_profiler().phase("map_update"):
            self.mapper.update_model(frame)
        self._debug_check_state()
        with get_profiler().phase("register_keyframe"):
            self.tracker.register_keyframe(frame)
        self._dlog().log_model(
            "world/model", self.local_models[-1].surfels)

    def initialize_new_local_model(self, frame: Frame) -> None:
        """Submap rollover / bootstrap."""
        logger.info("Inserting new local model")
        lmodel = LocalModel(self.cfg, device=self.device)
        if len(self.local_models) == 0:
            world_T_lmodel_old = np.eye(4)
        else:
            world_T_lmodel_old = self.local_models[-1].world_T_model
        lmodel.world_T_model = world_T_lmodel_old @ frame.model_T_frame
        frame.model_T_frame = np.eye(4)
        lmodel.insert_keyframe(frame)
        self.local_models.append(lmodel)
        self.mapper.register_model(lmodel)
        with get_profiler().phase("map_update"):
            self.mapper.update_model(frame, initialize_model=True)
        self._debug_check_state()
        self.tracker.register_model(lmodel)
        self.tracker.register_keyframe(frame)
        # the caller appends the frame to self.frames, once
        self._dlog().log_model("world/model", lmodel.surfels)

    def _debug_check_state(self) -> None:
        """Sanitizer (logging.debug_checks): active surfel params + Adam
        moments must be finite after every map update."""
        if not self.cfg.logging.debug_checks:
            return
        from ..debug import assert_finite_state
        lm = self.local_models[-1]
        assert_finite_state(
            {"params": lm.surfels.params, "adam": lm.adam},
            active=lm.surfels.active,
            what=f"map state after keyframe {len(lm.keyframes)}")

    def _maybe_checkpoint(self) -> None:
        every = self.cfg.output.checkpoint_every_keyframes
        ckpt_dir = self.cfg.output.checkpoint_dir
        if not every or every <= 0 or not ckpt_dir:
            return
        self._keyframes_since_ckpt += 1
        if self._keyframes_since_ckpt >= every:
            if self.writes:
                from ..checkpoint import save_checkpoint
                with get_profiler().phase("checkpoint"):
                    save_checkpoint(ckpt_dir, self)
            self._keyframes_since_ckpt = 0

    def save_results(self) -> Path | None:
        """Write cfg.yaml / odom.txt / graph.yaml / models/*.ply (on rank 0
        under a mesh; the other ranks write nothing and return None)."""
        if not self.writes:
            return None
        ofolder = self.cfg.output.folder or "results/"
        result_folder = Path(ofolder) / self.date_start
        result_folder.mkdir(parents=True, exist_ok=False)
        logger.info(f"Saving results in {result_folder}")
        (result_folder / "models").mkdir(parents=True, exist_ok=True)
        save_configuration(result_folder / "cfg.yaml", self.cfg)

        writer_type = self.cfg.output.writer or TrajectoryWriterType.tum
        writer = trajectory_writer_available[writer_type]
        writer.write(result_folder / "odom.txt", self.world_T_odom,
                     self.timestamps)

        rgraph = ResultGraph.from_slam(self.cfg, self.local_models,
                                       Path("models"))
        rgraph.save(result_folder / "graph.yaml")
        for i, rmodel in enumerate(rgraph.models):
            arrs = S.compact_arrays(self.local_models[i].surfels)
            plyio.save_surfel_ply(result_folder / rmodel.filename,
                                  arrs["xyz"], arrs["logit_opacity"],
                                  arrs["log_scale"], arrs["quat"])
        return result_folder
