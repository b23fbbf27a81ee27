"""Result graph + mesh extraction.

The result graph is the serialized experiment (models + keyframes +
intrinsics) in the JAX package's YAML schema, so either package reads the
other's results.  Mesh extraction, the port's counterpart of
splatloam_tpu/postprocessing.py, offers two paths, both fed by
``render_graph_points`` (every keyframe of every submap rendered through
``render``: the forward kernel K1 with the median and the distortion
term, on ``device``):

  * ``mesh_tsdf``: TSDF fusion (``eval.tsdf.fuse_points_tsdf``, torch on
    the device) + marching tetrahedra (numpy);
  * ``mesh_poisson``: Open3D's screened Poisson when it can be imported,
    else the grid Poisson solver (``eval.tsdf.poisson_grid``, numpy).

Each step is a phase of the global profiler: ``mesh.render`` per keyframe
(the render and its read-back), ``mesh.fuse``, ``mesh.marching_cubes``
and ``mesh.poisson``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import yaml

from .config import Configuration, from_dict, to_dict
from .logging_utils import get_logger
from .profiling import get_profiler

logger = get_logger("postprocessing")


@dataclass
class ResultFrame:
    # mirrors ref scene/postprocessing.py:29-35
    id: int = 0
    timestamp: float = 0.0
    model_T_frame: list = field(default_factory=list)   # 3x4 row-major
    projmatrix: list = field(default_factory=list)      # [fx, fy, cx, cy]
    model_id: int = 0


@dataclass
class ResultModel:
    # mirrors ref scene/postprocessing.py:21-26
    id: int = 0
    world_T_model: list = field(default_factory=list)   # 3x4 row-major
    filename: str = ""
    frame_ids: list = field(default_factory=list)


@dataclass
class ResultGraph:
    # mirrors ref scene/postprocessing.py:38-90
    models: list = field(default_factory=list)
    frames: list = field(default_factory=list)

    def __str__(self):
        return (f"ResultGraph with {len(self.models)} models "
                f"and {len(self.frames)} frames.")

    @staticmethod
    def from_slam(cfg: Configuration, local_models, output_dir: Path
                  ) -> "ResultGraph":
        frame_id = 0
        model_lst, frame_lst = [], []
        for mid, model in enumerate(local_models):
            wTm = np.asarray(model.world_T_model)[:3].reshape(-1)
            filename = str(Path(output_dir) / f"{mid:04d}.ply")
            frame_ids = []
            for frame in model.keyframes:
                mTf = np.asarray(frame.model_T_frame)[:3].reshape(-1)
                K = frame.camera.K.cpu().numpy()
                projmatrix = [float(K[0, 0]), float(K[1, 1]),
                              float(K[0, 2]), float(K[1, 2])]
                frame_lst.append(ResultFrame(
                    id=frame_id, timestamp=frame.timestamp,
                    model_T_frame=[float(x) for x in mTf],
                    projmatrix=projmatrix, model_id=mid))
                frame_ids.append(frame_id)
                frame_id += 1
            model_lst.append(ResultModel(
                id=mid, filename=filename,
                world_T_model=[float(x) for x in wTm],
                frame_ids=frame_ids))
        return ResultGraph(models=model_lst, frames=frame_lst)

    @staticmethod
    def from_yaml(filename: Path) -> "ResultGraph":
        with open(filename) as f:
            data = yaml.safe_load(f)
        graph = ResultGraph()
        for m in data.get("models", []):
            graph.models.append(from_dict(ResultModel, m))
        for fr in data.get("frames", []):
            graph.frames.append(from_dict(ResultFrame, fr))
        return graph

    def save(self, filename: Path) -> None:
        with open(filename, "w") as f:
            yaml.safe_dump(to_dict(self), f, sort_keys=False)


def _pose_3x4(vals) -> np.ndarray:
    T = np.vstack([np.asarray(vals, np.float64).reshape(3, 4),
                   [0, 0, 0, 1]])
    return T


def _intrinsics_K(projmatrix) -> np.ndarray:
    fx, fy, cx, cy = projmatrix
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    return K


def render_graph_points(graph: ResultGraph, cfg: Configuration,
                        graph_directory: Path,
                        kf_interval: int | None = -1,
                        kf_samples: int | None = 5000,
                        min_opacity: float = 0.5,
                        max_depth_dist: float = 0.1,
                        use_median_depth: bool = False,
                        seed: int = 0, device=None):
    """Steps 1-4 of ref mesh_poisson (:105-189): re-render each keyframe,
    filter by alpha/distortion, back-project, sample, merge in world frame.
    The renders run on ``device`` (default cuda; raises without a GPU);
    the sampling and the world transform run on the host.

    Returns (points [M, 3], normals [M, 3]) numpy arrays.
    """
    import torch

    from .device import resolve_device
    from .geometry import spherical
    from .io.ply import load_surfel_ply
    from .ops.rasterizer.api import RenderParams, render

    dev = resolve_device(device)
    height = cfg.preprocessing.image_height
    width = cfg.preprocessing.image_width
    cc = cfg.compute
    params = RenderParams(height=height, width=width,
                          backend=cc.backend.value, chunk=cc.chunk,
                          tile_h=cc.tile_h, tile_w=cc.tile_w,
                          tile_list_capacity=cc.tile_list_capacity)
    rng = np.random.default_rng(seed)
    all_pts, all_nrm = [], []
    frames_by_id = {f.id: f for f in graph.frames}
    processed = 0
    prof = get_profiler()

    def on_dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    for rmodel in graph.models:
        xyz, opac, log_scale, quat = load_surfel_ply(
            Path(graph_directory) / rmodel.filename)
        world_T_model = _pose_3x4(rmodel.world_T_model)
        surfels = [on_dev(a) for a in (xyz, np.exp(log_scale), quat,
                                       1.0 / (1.0 + np.exp(-opac)))]
        for rfid in rmodel.frame_ids:
            processed += 1
            if kf_interval is not None and kf_interval > 0 and \
                    (processed % kf_interval):
                continue
            rframe = frames_by_id[rfid]
            model_T_frame = _pose_3x4(rframe.model_T_frame)
            K = on_dev(_intrinsics_K(rframe.projmatrix))
            T_cw = on_dev(np.linalg.inv(model_T_frame))
            depth_ratio = 1.0 if use_median_depth else 0.0
            with prof.phase("mesh.render"), torch.no_grad():
                pkg = render(*surfels, T_cw, K, params, depth_ratio)
                pts = spherical.depth_to_points(pkg["surf_depth"], K,
                                                on_dev(model_T_frame))
                normals = pkg["rend_normal"].cpu().numpy()
                alpha = pkg["rend_alpha"].cpu().numpy()
                dist = pkg["rend_dist"].cpu().numpy()
            invalid = (alpha < min_opacity) | (dist > max_depth_dist)
            # normals are in model frame; rotate to world below
            pts = pts.cpu().numpy()[~invalid]
            nrm = normals[~invalid]
            if len(pts) == 0:
                continue
            if kf_samples is not None and kf_samples > 0:
                sel = rng.choice(len(pts), min(kf_samples, len(pts)),
                                 replace=False)
                pts, nrm = pts[sel], nrm[sel]
            pts = pts @ world_T_model[:3, :3].T + world_T_model[:3, 3]
            nrm = nrm @ world_T_model[:3, :3].T
            all_pts.append(pts)
            all_nrm.append(nrm)
    if not all_pts:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.concatenate(all_pts), np.concatenate(all_nrm)


def mesh_tsdf(graph: ResultGraph, cfg: Configuration, graph_directory: Path,
              voxel_size: float = 0.1, trunc: float = 0.3,
              kf_interval: int | None = -1, kf_samples: int | None = None,
              min_opacity: float = 0.5, max_depth_dist: float = 0.1,
              use_median_depth: bool = False, device=None):
    """Fuse rendered keyframe clouds into a TSDF (on ``device``) and run
    marching tetrahedra.  Returns (vertices [V,3], triangles [T,3])."""
    from .eval.tsdf import fuse_points_tsdf, marching_cubes

    pts, nrm = render_graph_points(
        graph, cfg, graph_directory, kf_interval=kf_interval,
        kf_samples=kf_samples, min_opacity=min_opacity,
        max_depth_dist=max_depth_dist, use_median_depth=use_median_depth,
        device=device)
    if len(pts) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    prof = get_profiler()
    with prof.phase("mesh.fuse"):
        tsdf, origin = fuse_points_tsdf(pts, nrm, voxel_size, trunc,
                                        device=device)
    with prof.phase("mesh.marching_cubes"):
        return marching_cubes(tsdf, origin, voxel_size)


def mesh_poisson(graph: ResultGraph, cfg: Configuration,
                 graph_directory: Path, kf_interval: int | None,
                 kf_samples: int | None, min_opacity: float,
                 poisson_depth: int | None, poisson_width: float | None,
                 poisson_min_density: float | None, max_depth_dist: float,
                 use_median_depth: bool, screen_voxels: float = 0.0,
                 device=None):
    """Reference-compatible Poisson meshing (ref
    scene/postprocessing.py:94-216).  The keyframes render on ``device``;
    the solve is host code: Open3D's octree screened Poisson when it can
    be imported, else the grid solver (eval.tsdf.poisson_grid).  Returns
    (vertices, triangles) numpy arrays.
    """
    pts, nrm = render_graph_points(
        graph, cfg, graph_directory, kf_interval=kf_interval,
        kf_samples=kf_samples, min_opacity=min_opacity,
        max_depth_dist=max_depth_dist, use_median_depth=use_median_depth,
        device=device)
    try:
        import open3d as o3d  # gated optional dependency
    except ImportError:
        from .eval.tsdf import MAX_VOXELS, poisson_grid
        if poisson_width and poisson_width > 0:
            voxel = float(poisson_width)
        else:
            extent = float((pts.max(0) - pts.min(0)).max()) if len(pts) \
                else 1.0
            voxel = extent / (2 ** (poisson_depth or 8))
        # clamp so the padded dense grid stays within the voxel budget
        if len(pts):
            span = pts.max(0) - pts.min(0)
            min_voxel = float(np.prod(span + 1e-3) ** (1 / 3)
                              / (0.8 * MAX_VOXELS ** (1 / 3)))
            voxel = max(voxel, min_voxel)
        with get_profiler().phase("mesh.poisson"):
            return poisson_grid(
                pts, nrm, voxel_size=voxel,
                density_quantile=poisson_min_density or 0.0,
                screen_voxels=screen_voxels)
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pts)
    pcd.normals = o3d.utility.Vector3dVector(nrm)
    pcd.remove_statistical_outlier(nb_neighbors=20, std_ratio=2.0)
    if (poisson_depth is None or poisson_depth < 0) and poisson_width and \
            poisson_width > 0:
        mesh, densities = \
            o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(
                pcd, width=poisson_width)
    else:
        mesh, densities = \
            o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(
                pcd, depth=poisson_depth)
    if poisson_min_density and poisson_min_density > 0:
        densities = np.asarray(densities)
        mesh.remove_vertices_by_mask(
            densities < np.quantile(densities, poisson_min_density))
    return (np.asarray(mesh.vertices),
            np.asarray(mesh.triangles).astype(np.int32))
