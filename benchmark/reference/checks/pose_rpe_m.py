"""pose_rpe_m, tracking: the tracker's poses against the generator's.

Over every pair of the window's frames (i, j) whose ground-truth
positions lie SEG_M apart along the route (j the first frame at SEG_M or
more from i), the translation error of the relative motion,
|| trans((gt_i^-1 gt_j)^-1 (est_i^-1 est_j)) ||; the check is the
largest, in metres.  The estimates are ``SLAM.world_T_odom``, one per
processed frame; the ground truth is ``SweepStream.pose``.  An error over
segments, not from the start: it does not grow with how far a faster
program drives in the same window.  A window shorter than SEG_M has no
segment and reads inf.

SEG_M is 20 m: some tens of sweeps at a car's 0.7 m a sweep, and longer
than the 5 m between keyframes, so that a segment spans keyframes and
a drift that each keyframe passes on adds up within it.
"""
from __future__ import annotations

import math

import numpy as np

SEG_M = 20.0


def observe(prog, run, stream) -> dict:
    est = prog.slam.world_T_odom
    if len(est) != prog.next_index:
        raise RuntimeError(f"{len(est)} poses for {prog.next_index} frames")
    window = [f["index"] for f in run.frames]
    return dict(window=window, est=np.stack([est[i] for i in window]))


def compare(obs, stream, cfg, workload, control) -> float:
    gt = np.stack([stream.pose(i) for i in obs["window"]])
    return segment_error(gt, obs["est"], SEG_M)


def segment_error(gt: np.ndarray, est: np.ndarray, seg_m: float) -> float:
    """The largest translation error (m) of the relative motion over the
    segments of ``seg_m`` along the ground truth's route; poses [n, 4,
    4], world_T_sensor."""
    gt = np.asarray(gt, np.float64)
    est = np.asarray(est, np.float64)
    steps = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)
    along = np.concatenate([[0.0], np.cumsum(steps)])
    j = np.searchsorted(along, along + seg_m, side="left")
    i = np.nonzero(j < len(gt))[0]
    if not len(i):
        return math.inf
    j = j[i]
    rel_gt = np.linalg.inv(gt[i]) @ gt[j]
    rel_est = np.linalg.inv(est[i]) @ est[j]
    err = np.linalg.inv(rel_gt) @ rel_est
    return float(np.max(np.linalg.norm(err[:, :3, 3], axis=1)))
