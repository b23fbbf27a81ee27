"""Result graph: the serialized experiment (models + keyframes +
intrinsics) in the JAX package's YAML schema, so either package reads the
other's results.

The port's copy of the first part of splatloam_tpu/postprocessing.py.
The meshing functions there (``render_graph_points``, ``mesh_tsdf``,
``mesh_poisson``) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import yaml

from .config import Configuration, from_dict, to_dict


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
