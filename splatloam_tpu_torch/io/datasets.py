"""Dataset readers: KITTI / VBR / NCD / OxSpires / generic.

The port's own copy of splatloam_tpu/io/datasets.py, on the port's
point-cloud and trajectory readers.  Re-implements ref scene/dataset_readers.py:26-317: each reader couples a
point-cloud reader with a trajectory reader and yields
(cloud [N,3] f32, timestamp, gt_pose 4x4) with timestamp-sync skip logic.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import Configuration, DatasetType
from ..logging_utils import get_logger
from .pointcloud import (PointCloudReader_BIN, PointCloudReader_PCD,
                         PointCloudReader_ROSBAG,
                         pointcloud_reader_available)
from .trajectory import (TrajectoryReader_KITTI, TrajectoryReader_NULL,
                         TrajectoryReader_TUM, TrajectoryReader_VILENS,
                         trajectory_reader_available)

logger = get_logger("datasets")


class DatasetReader:
    """Base reader with sync-skip semantics (ref :26-70)."""

    def __init__(self, cfg: Configuration):
        self.cfg = cfg
        self.cloud_reader = None
        self.traj_reader = None

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            cloud, timestamp = next(self.cloud_reader)
            try:
                gt_pose = self.traj_reader(timestamp)
                return cloud, timestamp, gt_pose
            except RuntimeError as e:
                if self.cfg.data.skip_clouds_wno_sync:
                    logger.warning(f"{e} | Skipping unsynchronized cloud "
                                   f"at {timestamp}")
                    continue
                logger.warning(f"{e} | Setting gt_pose as identity")
                return cloud, timestamp, np.eye(4)

    def __len__(self):
        return len(self.cloud_reader)


class DatasetReader_KITTI(DatasetReader):
    """KITTI velodyne folder + times.txt + calib.txt (ref :73-112)."""

    def __init__(self, cfg: Configuration):
        super().__init__(cfg)
        pc_cfg = cfg.data.cloud_reader
        base = Path(pc_cfg.cloud_folder)
        if "velodyne" in base.name:
            pc_cfg.timestamp_filename = str(base.parent / "times.txt")
        else:
            pc_cfg.cloud_folder = str(base / "velodyne")
            pc_cfg.timestamp_filename = str(base / "times.txt")
        self.cloud_reader = PointCloudReader_BIN(pc_cfg)
        tr_cfg = cfg.data.trajectory_reader
        calib = base / "calib.txt"
        if calib.is_file():
            tr_cfg.gt_T_sensor_kitti_filename = str(calib)
        if tr_cfg.filename is None or not Path(tr_cfg.filename).is_file():
            self.traj_reader = TrajectoryReader_NULL(tr_cfg)
        else:
            if tr_cfg.timestamp_from_filename_kitti is None:
                tr_cfg.timestamp_from_filename_kitti = \
                    pc_cfg.timestamp_filename
            self.traj_reader = TrajectoryReader_KITTI(tr_cfg)

    def __next__(self):
        # KITTI poses are index-aligned, not timestamped (ref :109-112)
        cloud, timestamp = next(self.cloud_reader)
        gt_pose = next(self.traj_reader)
        return cloud, timestamp, gt_pose


def _rosbag_reader(cfg: Configuration, default_topic: str,
                   gt_T_sensor: list[float]):
    pc_cfg = cfg.data.cloud_reader
    if pc_cfg.rosbag_topic is None:
        pc_cfg.rosbag_topic = default_topic
    tr_cfg = cfg.data.trajectory_reader
    tr_cfg.gt_T_sensor_t_xyz_q_xyzw = gt_T_sensor
    cloud_reader = PointCloudReader_ROSBAG(pc_cfg)
    if tr_cfg.filename is None or not Path(tr_cfg.filename).is_file():
        traj_reader = TrajectoryReader_NULL(tr_cfg)
    else:
        traj_reader = TrajectoryReader_TUM(tr_cfg)
    return cloud_reader, traj_reader


class DatasetReader_VBR(DatasetReader):
    """VBR rosbags, /ouster/points (ref :115-151)."""

    def __init__(self, cfg: Configuration):
        super().__init__(cfg)
        self.cloud_reader, self.traj_reader = _rosbag_reader(
            cfg, "/ouster/points", [0, 0, 0, 0, 0, 0, 1])


class DatasetReader_NCD(DatasetReader):
    """Newer College rosbags, /os_cloud_node/points (ref :154-194)."""

    def __init__(self, cfg: Configuration):
        super().__init__(cfg)
        self.cloud_reader, self.traj_reader = _rosbag_reader(
            cfg, "/os_cloud_node/points", [0.001, 0, 0.091, 0, 0, 0, 1])


class DatasetReader_OXSPIRES(DatasetReader):
    """Oxford Spires rosbags, /hesai/pandar (ref :197-236)."""

    def __init__(self, cfg: Configuration):
        super().__init__(cfg)
        self.cloud_reader, self.traj_reader = _rosbag_reader(
            cfg, "/hesai/pandar", [0, 0, 0.124, 0, 0, 1, 0])


class DatasetReader_OXSPIRES_VILENS(DatasetReader):
    """Oxford Spires pcd + VILENS csv (ref :239-276)."""

    def __init__(self, cfg: Configuration):
        super().__init__(cfg)
        pc_cfg = cfg.data.cloud_reader
        pc_cfg.timestamp_from_filename = True
        self.cloud_reader = PointCloudReader_PCD(pc_cfg)
        tr_cfg = cfg.data.trajectory_reader
        tr_cfg.gt_T_sensor_t_xyz_q_xyzw = [0, 0, 0, 0, 0, 0, 1]
        if tr_cfg.filename is None or not Path(tr_cfg.filename).is_file():
            self.traj_reader = TrajectoryReader_NULL(tr_cfg)
        else:
            self.traj_reader = TrajectoryReader_VILENS(tr_cfg)


class DatasetReader_GENERIC(DatasetReader):
    """Any cloud format x any trajectory format (ref :279-301)."""

    def __init__(self, cfg: Configuration):
        super().__init__(cfg)
        pc_cfg = cfg.data.cloud_reader
        tr_cfg = cfg.data.trajectory_reader
        self.cloud_reader = \
            pointcloud_reader_available[pc_cfg.cloud_format](pc_cfg)
        self.traj_reader = \
            trajectory_reader_available[tr_cfg.reader_type](tr_cfg)


datasetreader_available = {
    DatasetType.vbr: DatasetReader_VBR,
    DatasetType.kitti: DatasetReader_KITTI,
    DatasetType.ncd: DatasetReader_NCD,
    DatasetType.oxspires: DatasetReader_OXSPIRES,
    DatasetType.oxspires_vilens: DatasetReader_OXSPIRES_VILENS,
    DatasetType.generic: DatasetReader_GENERIC,
}


def get_dataset_reader(cfg: Configuration) -> DatasetReader:
    return datasetreader_available[cfg.data.dataset_type](cfg)
