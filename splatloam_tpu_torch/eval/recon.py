"""Reconstruction evaluation: accuracy / completeness / Chamfer-L1 / F-score.

The port's copy of splatloam_tpu/eval/recon.py (host code: numpy and
scipy, no tensor): mesh loading via the port's io.ply, uniform
triangle-area sampling, voxel downsampling via unique voxel keys,
truncated nearest-neighbor distances via scipy cKDTree.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial import cKDTree

from ..io import ply as plyio
from ..logging_utils import get_logger

logger = get_logger("eval")


def load_mesh(filename: str | Path):
    """Read a triangle mesh PLY -> (vertices [V,3], faces [F,3] or None)."""
    with open(filename, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    has_faces = any("element face" in ln for ln in header)
    verts_d = plyio.read_ply(filename)
    verts = np.stack([verts_d["x"], verts_d["y"], verts_d["z"]], axis=1)
    faces = None
    if has_faces:
        faces = _read_ply_faces(filename)
    return verts, faces


def _read_ply_faces(filename):
    """Parse the face element (list uchar int vertex_indices)."""
    with open(filename, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]
    fmt = "ascii"
    n_verts = n_faces = 0
    vert_itemsize = 0
    vert_props = 0
    current = None
    count_type = idx_type = None
    for ln in header:
        tok = ln.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            current = tok[1]
            if current == "vertex":
                n_verts = int(tok[2])
            elif current == "face":
                n_faces = int(tok[2])
        elif tok[0] == "property":
            if current == "vertex" and tok[1] != "list":
                vert_itemsize += np.dtype(
                    plyio._PLY_TO_NP[tok[1]]).itemsize
                vert_props += 1
            elif current == "face" and tok[1] == "list":
                count_type = plyio._PLY_TO_NP[tok[2]]
                idx_type = plyio._PLY_TO_NP[tok[3]]
    if fmt == "ascii":
        lines = body.decode().splitlines()
        faces = []
        for ln in lines[n_verts:n_verts + n_faces]:
            vals = ln.split()
            k = int(vals[0])
            faces.append([int(v) for v in vals[1:1 + k]][:3])
        return np.asarray(faces, np.int64)
    bo = "<" if fmt == "binary_little_endian" else ">"
    pos = n_verts * vert_itemsize
    cnt_dt = np.dtype(bo + count_type)
    idx_dt = np.dtype(bo + idx_type)
    faces = np.empty((n_faces, 3), np.int64)
    for i in range(n_faces):
        k = int(np.frombuffer(body, cnt_dt, 1, pos)[0])
        pos += cnt_dt.itemsize
        idx = np.frombuffer(body, idx_dt, k, pos)
        pos += k * idx_dt.itemsize
        faces[i] = idx[:3]
    return faces


def sample_mesh_uniform(verts: np.ndarray, faces: np.ndarray, n: int,
                        seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (o3d sample_points_uniformly
    equivalent)."""
    rng = np.random.default_rng(seed)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        return verts[rng.integers(0, len(verts), n)]
    probs = areas / total
    tri = rng.choice(len(faces), size=n, p=probs)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    return (a[tri] + u[:, None] * (b[tri] - a[tri])
            + v[:, None] * (c[tri] - a[tri]))


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Mean point per occupied voxel (o3d voxel_down_sample equivalent)."""
    if voxel <= 0 or len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 3))
    np.add.at(sums, inv, points)
    return sums / counts[:, None]


def nn_correspondence(target_verts: np.ndarray, source_verts: np.ndarray,
                      truncation_dist: float, ignore_outliers: bool):
    """Truncated NN distances source->target (ref :157-199)."""
    if len(target_verts) == 0 or len(source_verts) == 0:
        logger.warning("Empty vertex set; cannot compute NN distances")
        return np.empty(0)
    tree = cKDTree(target_verts)
    dist, _ = tree.query(source_verts, k=1)
    if ignore_outliers:
        return dist[dist < truncation_dist]
    return np.minimum(dist, truncation_dist)


def evaluate_recon(reference_filename: Path, estimate_filename: Path,
                   down_sample_res: float = 0.02, threshold: float = 0.2,
                   truncation_acc: float = 0.5, truncation_com: float = 0.5,
                   gt_bbox_mask_on: bool = True,
                   mesh_sample_point: int = 10_000_000,
                   generate_error_map: bool = False,
                   error_map_filename=None) -> dict:
    """Mesh-vs-reference-cloud metrics (ref utils/eval_utils.py:67-154).

    ``generate_error_map`` (a NotImplementedError stub in the reference,
    ref utils/eval_utils.py:93) is implemented here: the accuracy
    distances are written as a heat-colored point cloud PLY next to the
    estimate (or at ``error_map_filename``).
    """
    logger.info(f"Opening estimate mesh {estimate_filename}")
    est_verts, est_faces = load_mesh(estimate_filename)
    logger.info(f"Opening reference cloud {reference_filename}")
    ref_verts, _ = load_mesh(reference_filename)

    if est_faces is not None and len(est_faces):
        est_pcd = sample_mesh_uniform(est_verts, est_faces,
                                      mesh_sample_point)
    else:
        est_pcd = est_verts
    if gt_bbox_mask_on and len(ref_verts):
        bmin = ref_verts.min(axis=0)
        bmax = ref_verts.max(axis=0)
        bmin[2] -= down_sample_res
        bmax[2] += down_sample_res
        inside = np.all((est_pcd >= bmin) & (est_pcd <= bmax), axis=1)
        est_pcd = est_pcd[inside]

    if down_sample_res > 0:
        before = len(est_pcd)
        est_pcd = voxel_downsample(est_pcd, down_sample_res)
        ref_verts = voxel_downsample(ref_verts, down_sample_res)
        logger.info(f"Estimate pcd from {before} to {len(est_pcd)}")

    dist_p = nn_correspondence(ref_verts, est_pcd, truncation_acc, True)
    dist_r = nn_correspondence(est_pcd, ref_verts, truncation_com, False)

    if generate_error_map and len(est_pcd):
        from ..io.ply import write_ply
        out = Path(error_map_filename) if error_map_filename else \
            Path(estimate_filename).with_suffix(".error_map.ply")
        t = np.clip(np.asarray(dist_p) / max(threshold, 1e-9), 0.0, 1.0)
        # blue (accurate) -> red (at/over threshold)
        r = (255 * t).astype(np.uint8)
        b = (255 * (1.0 - t)).astype(np.uint8)
        g = (255 * (1.0 - np.abs(2 * t - 1.0))).astype(np.uint8)
        write_ply(out, {"x": est_pcd[:, 0], "y": est_pcd[:, 1],
                        "z": est_pcd[:, 2],
                        "red": r, "green": g, "blue": b})
        logger.info(f"Wrote error map to {out}")

    dist_p_mean = float(np.mean(dist_p)) if len(dist_p) else np.nan
    dist_r_mean = float(np.mean(dist_r)) if len(dist_r) else np.nan
    chamfer_l1 = 0.5 * (dist_p_mean + dist_r_mean)
    precision = float(np.mean(dist_p < threshold)) * 100 \
        if len(dist_p) else 0.0
    recall = float(np.mean(dist_r < threshold)) * 100 \
        if len(dist_r) else 0.0
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "MAE_accuracy (cm)": dist_p_mean * 100,
        "MAE_completeness (cm)": dist_r_mean * 100,
        "Chamfer_L1 (cm)": chamfer_l1 * 100,
        "Precision [Accuracy] (%)": precision,
        "Recall [Completeness] (%)": recall,
        "F-score (%)": fscore,
        "Inlier_threshold (m)": threshold,
        "Outlier_truncation_acc (m)": truncation_acc,
        "Outlier_truncation_com (m)": truncation_com,
    }


def crop_union(reference_filename: Path, estimate_filenames: list,
               threshold_dist: float = 1.2,
               mesh_sample_point: int = 10_000_000) -> np.ndarray:
    """Crop the reference cloud to the union of estimate meshes
    (ref :202-250); returns the cropped points."""
    ref_verts, _ = load_mesh(reference_filename)
    merged = []
    for f in estimate_filenames:
        verts, faces = load_mesh(f)
        if faces is not None and len(faces):
            merged.append(sample_mesh_uniform(verts, faces,
                                              mesh_sample_point))
        else:
            merged.append(verts)
    merged = np.concatenate(merged)
    tree = cKDTree(merged)
    dist, _ = tree.query(ref_verts, k=1)
    return ref_verts[dist < threshold_dist]
