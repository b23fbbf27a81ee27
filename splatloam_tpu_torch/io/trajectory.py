"""Trajectory readers/writers: KITTI / TUM / VILENS / NULL.

The port's own copy of splatloam_tpu/io/trajectory.py (numpy only):
timestamp-closest lookup with tolerance, sensor extrinsic gt_T_s from
pos-quat or KITTI calib, and TUM/KITTI writers with rotation
re-orthonormalization.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import List

import numpy as np

from ..config import (TrajectoryReaderConfig, TrajectoryReaderType,
                      TrajectoryWriterType)
from . import rotations as rot


def read_timestamps(filename: str | Path) -> List[float]:
    """One float timestamp per non-empty line (the point-cloud readers'
    helper; those readers are not ported yet)."""
    with open(filename) as f:
        return [float(line.strip()) for line in f if line.strip()]


class TrajectoryReader:
    """Base reader (ref utils/trajectory_utils.py:19-78)."""

    def __init__(self, config: TrajectoryReaderConfig):
        self.dtol = config.timestamp_dtol
        self.timestamps: List[float] = []
        self.poses: List[np.ndarray] = []
        self.current_index = 0
        if config.gt_T_sensor_t_xyz_q_xyzw is not None:
            pq = np.asarray(config.gt_T_sensor_t_xyz_q_xyzw, np.float64)
            pq = np.concatenate([pq[:3], rot.quat_wxyz_from_xyzw(pq[3:])])
            self.gt_T_s = rot.transform_from_pq(pq)
        elif config.gt_T_sensor_kitti_filename is not None:
            self.gt_T_s = np.eye(4)
            with open(config.gt_T_sensor_kitti_filename) as f:
                for line in f:
                    if "Tr:" not in line:
                        continue
                    vals = np.array([float(x) for x in line[3:].split()])
                    self.gt_T_s = np.vstack([vals.reshape(3, 4),
                                             [0, 0, 0, 1]])
        else:
            self.gt_T_s = np.eye(4)

    def __call__(self, timestamp: float) -> np.ndarray:
        idx = self._find_closest_timestamp_idx(timestamp)
        return self.poses[idx] @ self.gt_T_s

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self.current_index >= len(self.poses):
            raise StopIteration
        pose = self.poses[self.current_index] @ self.gt_T_s
        self.current_index += 1
        return pose

    def __getitem__(self, idx) -> np.ndarray:
        return self.poses[idx]

    def _find_closest_timestamp_idx(self, timestamp: float) -> int:
        ts = np.asarray(self.timestamps)
        if ts.size == 0:
            raise RuntimeError("trajectory has no timestamps")
        idx = int(np.argmin(np.abs(ts - timestamp)))
        if abs(ts[idx] - timestamp) > self.dtol:
            raise RuntimeError(
                f"No timestamp found within tolerance {self.dtol}")
        return idx


class TrajectoryReader_KITTI(TrajectoryReader):
    """3x4 row-major pose per line; index-only access (ref :81-108)."""

    def __init__(self, config: TrajectoryReaderConfig):
        super().__init__(config)
        with open(config.filename) as f:
            for line in f:
                if not line.strip():
                    continue
                vals = np.array([float(x) for x in line.split()])
                self.poses.append(np.vstack([vals.reshape(3, 4),
                                             [0, 0, 0, 1]]))
        if config.timestamp_from_filename_kitti is not None:
            self.timestamps = read_timestamps(
                config.timestamp_from_filename_kitti)

    def __call__(self, _: float) -> np.ndarray:
        raise RuntimeError(
            "TrajectoryReader_KITTI does not allow random access")

    def _find_closest_timestamp_idx(self, _: float) -> int:
        raise RuntimeError(
            "TrajectoryReader_KITTI does not allow timestamped access")


class TrajectoryReader_TUM(TrajectoryReader):
    """'timestamp x y z qx qy qz qw' per line (ref :111-131)."""

    def __init__(self, config: TrajectoryReaderConfig):
        super().__init__(config)
        with open(config.filename) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                line = re.sub(" {2,}", " ", line)
                vals = np.array([float(x) for x in re.split(" |, ", line)])
                self.timestamps.append(float(vals[0]))
                pq = np.concatenate(
                    [vals[1:4], rot.quat_wxyz_from_xyzw(vals[4:8])])
                self.poses.append(rot.transform_from_pq(pq))


class TrajectoryReader_VILENS(TrajectoryReader):
    """'counter, sec, nsec, x, y, z, qx, qy, qz, qw' (ref :133-152)."""

    def __init__(self, config: TrajectoryReaderConfig):
        super().__init__(config)
        with open(config.filename) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                vals = np.array([float(x) for x in re.split(" |, ", line)])
                self.timestamps.append(float(vals[1] + vals[2] / 1e9))
                pq = np.concatenate(
                    [vals[3:6], rot.quat_wxyz_from_xyzw(vals[6:10])])
                self.poses.append(rot.transform_from_pq(pq))


class TrajectoryReader_NULL(TrajectoryReader):
    """Always identity (ref :155-174)."""

    def __call__(self, _: float) -> np.ndarray:
        return np.eye(4)

    def __next__(self):
        return np.eye(4)

    def __getitem__(self, idx):
        return np.eye(4)


trajectory_reader_available = {
    TrajectoryReaderType.kitti: TrajectoryReader_KITTI,
    TrajectoryReaderType.tum: TrajectoryReader_TUM,
    TrajectoryReaderType.vilens: TrajectoryReader_VILENS,
    TrajectoryReaderType.null: TrajectoryReader_NULL,
}


def _fix_pose(pose: np.ndarray) -> np.ndarray:
    pose = np.array(pose, np.float64)
    pose[3] = [0, 0, 0, 1]
    pose[:3, :3] = rot.orthonormalize(pose[:3, :3])
    return pose


class TrajectoryWriter_TUM:
    """(ref utils/trajectory_utils.py:185-214)"""

    @staticmethod
    def write(filename: Path, poses: List[np.ndarray],
              timestamps: List[float]) -> None:
        filename = Path(filename)
        filename.parent.mkdir(parents=True, exist_ok=True)
        with open(filename, "w") as f:
            f.write("#timestamp tx ty tz qx qy qz qw\n")
            for timestamp, pose in zip(timestamps, poses):
                wtc = _fix_pose(pose)
                q = rot.quat_from_rotmat(wtc[:3, :3])  # wxyz
                t = wtc[:3, 3]
                f.write(f"{timestamp:.6f} {t[0]:.4f} {t[1]:.4f} "
                        f"{t[2]:.4f} {q[1]} {q[2]} {q[3]} {q[0]}\n")


class TrajectoryWriter_KITTI:
    """(ref utils/trajectory_utils.py:217-242)"""

    @staticmethod
    def write(filename: Path, poses: List[np.ndarray],
              timestamps: List[float] | None = None) -> None:
        filename = Path(filename)
        filename.parent.mkdir(parents=True, exist_ok=True)
        with open(filename, "w") as f:
            for pose in poses:
                wtc = _fix_pose(pose)
                row = wtc[:3].reshape(-1)
                f.write(" ".join(f"{x:.6f}" for x in row) + "\n")


trajectory_writer_available = {
    TrajectoryWriterType.tum: TrajectoryWriter_TUM,
    TrajectoryWriterType.kitti: TrajectoryWriter_KITTI,
}
