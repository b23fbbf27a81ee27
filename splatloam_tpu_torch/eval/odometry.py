"""Odometry evaluation: multi-scale RPE over path-length fractions.

The port's own copy of splatloam_tpu/eval/odometry.py (numpy only).
Re-implements the protocol of ref utils/eval_utils.py:16-64 without the
``evo`` package: relative pose error with the *point_distance* pose
relation (norm of the difference of relative translation vectors), all
pairs whose accumulated path length matches delta within a 10% relative
tolerance, evaluated at deltas = {2,3,5,8,13,21,34,55}% of the path length,
each error normalized by its delta; returns (mean, std) over all pairs of
all deltas.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..logging_utils import get_logger

logger = get_logger("eval")

PERCENTAGES = (0.02, 0.03, 0.05, 0.08, 0.13, 0.21, 0.34, 0.55)


def associate_trajectories(ref_ts, ref_poses, est_ts, est_poses,
                           max_diff: float = 0.05):
    """Timestamp association with evo's documented semantics.

    evo ``sync.associate_trajectories`` implements the TUM RGB-D tools'
    ``associate.py`` algorithm: enumerate ALL candidate pairs within
    ``max_diff``, sort them globally by |time difference|, and greedily
    accept pairs whose endpoints are both still unmatched.  (A
    first-come nearest-neighbor loop — the previous implementation —
    diverges on near-duplicate timestamps: an early estimate can steal a
    reference stamp that a later estimate matches strictly better.)
    Matches are returned in estimate-timestamp order, as evo does.
    """
    ref_ts = np.asarray(ref_ts, np.float64)
    est_ts = np.asarray(est_ts, np.float64)
    diff = np.abs(ref_ts[None, :] - est_ts[:, None])    # [E, R]
    ei, ri = np.nonzero(diff <= max_diff)
    order = np.argsort(diff[ei, ri], kind="stable")
    used_ref, used_est = set(), set()
    picked = []
    for k in order:
        i, j = int(ei[k]), int(ri[k])
        if i in used_est or j in used_ref:
            continue
        used_est.add(i)
        used_ref.add(j)
        picked.append((i, j))
    picked.sort()                                       # est-stamp order
    matched_ref = [ref_poses[j] for _, j in picked]
    matched_est = [est_poses[i] for i, _ in picked]
    return matched_ref, matched_est


def path_lengths(poses: List[np.ndarray]) -> np.ndarray:
    """Cumulative path length per pose, [N]."""
    pts = np.stack([p[:3, 3] for p in poses])
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def _pairs_from_path(cum: np.ndarray, delta: float, tol: float):
    """All (i, j) with |path(i..j) - delta| <= tol * delta, j > i."""
    pairs = []
    n = len(cum)
    j = 0
    for i in range(n):
        target = cum[i] + delta
        # advance a window over candidate end-points
        j = max(j, i + 1)
        while j < n and cum[j] < target - tol * delta:
            j += 1
        k = j
        while k < n and cum[k] <= target + tol * delta:
            pairs.append((i, k))
            k += 1
    return pairs


def _relative_translation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Translation of inv(a) @ b."""
    return a[:3, :3].T @ (b[:3, 3] - a[:3, 3])


def evaluate_rpe(estimated_trajectory: List[np.ndarray],
                 gt_trajectory: List[np.ndarray],
                 timestamps: List[float] | None = None,
                 gt_timestamps: List[float] | None = None,
                 is_kitti: bool = False):
    """Returns (mean, std) of delta-normalized point-distance RPE."""
    if is_kitti or timestamps is None or gt_timestamps is None:
        ref = gt_trajectory[:len(estimated_trajectory)]
        est = estimated_trajectory[:len(ref)]
    else:
        ref, est = associate_trajectories(
            gt_timestamps, gt_trajectory, timestamps,
            estimated_trajectory)
    if len(ref) < 2:
        raise ValueError("not enough associated poses for RPE")

    cum_ref = path_lengths(ref)
    cum_est = path_lengths(est)
    ref_length = min(cum_ref[-1], cum_est[-1])
    logger.info(f"Reference length: {cum_ref[-1]:.3f} m, "
                f"Estimate length: {cum_est[-1]:.3f} m")

    errors = []
    for perc in PERCENTAGES:
        delta = ref_length * perc
        if delta <= 0:
            continue
        pairs = _pairs_from_path(cum_ref, delta, tol=0.1)
        if not pairs:
            logger.warning(f"no pose pairs at delta={delta:.2f} m "
                           f"({perc*100:.0f}%)")
            continue
        errs = np.array([
            np.linalg.norm(_relative_translation(ref[i], ref[j]) -
                           _relative_translation(est[i], est[j]))
            for i, j in pairs])
        errors.append(errs / delta)
    if not errors:
        raise ValueError("no valid RPE deltas (trajectory too short)")
    all_errors = np.concatenate(errors)
    return float(all_errors.mean()), float(all_errors.std())
