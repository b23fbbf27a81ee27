"""Mid-run checkpoint / resume of a SLAM run.

The port's copy of splatloam_tpu/checkpoint.py, in the same format
(``FORMAT_VERSION`` 1): one ``model_NNNN.npz`` per submap (surfel params,
Adam state, keyframe cameras and poses), ``world_T_odom.npy``,
``keyframe_T_frame.npy`` and ``manifest.json``.  A checkpoint written by
either package loads in the other, so in-flight SLAM state can move
between them.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .logging_utils import get_logger
from .model import surfels as S
from .model.camera import Camera
from .model.frame import Frame

logger = get_logger("checkpoint")

FORMAT_VERSION = 1


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _frame_arrays(frame: Frame, prefix: str) -> dict:
    cam = frame.camera
    return {
        f"{prefix}_K": _np(cam.K),
        f"{prefix}_T_cw": _np(cam.T_cw),
        f"{prefix}_depth": _np(cam.depth),
        f"{prefix}_normal": _np(cam.normal),
        f"{prefix}_valid": _np(cam.valid),
        f"{prefix}_meta": np.array([frame.timestamp]),
        f"{prefix}_model_T_frame": np.asarray(frame.model_T_frame),
        f"{prefix}_world_T_frame": np.asarray(frame.world_T_frame),
    }


def _frame_from_arrays(d, prefix: str, device) -> Frame:
    def put(name, dtype=torch.float32):
        return torch.from_numpy(np.array(d[f"{prefix}_{name}"])).to(
            dtype=dtype, device=device)

    cam = Camera(K=put("K"), T_cw=put("T_cw"), depth=put("depth"),
                 normal=put("normal"), valid=put("valid", torch.bool))
    return Frame(camera=cam, timestamp=float(d[f"{prefix}_meta"][0]),
                 model_T_frame=d[f"{prefix}_model_T_frame"],
                 world_T_frame=d[f"{prefix}_world_T_frame"])


def save_checkpoint(directory: str | Path, slam) -> Path:
    """Snapshot a SLAM instance's full in-flight state."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {
        "version": FORMAT_VERSION,
        "n_models": len(slam.local_models),
        "n_frames_processed": len(slam.frames),
        "timestamps": [float(t) for t in slam.timestamps],
        "date_start": slam.date_start,
    }
    np.save(directory / "world_T_odom.npy",
            np.stack(slam.world_T_odom) if slam.world_T_odom
            else np.zeros((0, 4, 4)))
    np.save(directory / "keyframe_T_frame.npy",
            np.asarray(slam.tracker.keyframe_T_frame))
    for mid, model in enumerate(slam.local_models):
        arrays = {
            "world_T_model": np.asarray(model.world_T_model),
            "active": _np(model.surfels.active),
            # a scalar int32, as the JAX package keeps its Adam step
            "adam_step": np.asarray(int(model.adam.step), np.int32),
            "n_keyframes": np.array([len(model.keyframes)]),
        }
        for name, arr in zip(S.SurfelParams._fields, model.surfels.params):
            arrays[f"param_{name}"] = _np(arr)
        for name, arr in zip(S.SurfelParams._fields, model.adam.mu):
            arrays[f"mu_{name}"] = _np(arr)
        for name, arr in zip(S.SurfelParams._fields, model.adam.nu):
            arrays[f"nu_{name}"] = _np(arr)
        for k, frame in enumerate(model.keyframes):
            arrays.update(_frame_arrays(frame, f"kf{k}"))
        np.savez_compressed(directory / f"model_{mid:04d}.npz", **arrays)
    with open(directory / "manifest.json", "w") as f:
        json.dump(manifest, f)
    logger.info(f"checkpoint saved to {directory} "
                f"({manifest['n_frames_processed']} frames, "
                f"{manifest['n_models']} submaps)")
    return directory


def load_checkpoint(directory: str | Path, slam) -> int:
    """Restore state into a freshly constructed SLAM, every tensor on the
    SLAM's device; returns the number of frames already processed (the
    caller skips that many inputs).  Each restored model's keyframe stack
    stays empty: the mapper rebuilds it from the keyframes at its next
    update."""
    from .model.local_model import LocalModel

    directory = Path(directory)
    dev = slam.device
    with open(directory / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["version"] == FORMAT_VERSION
    odom = np.load(directory / "world_T_odom.npy")
    slam.world_T_odom = [odom[i] for i in range(len(odom))]
    slam.timestamps = list(manifest["timestamps"])
    slam.date_start = manifest["date_start"]
    slam.local_models = []

    def params(d, prefix):
        return S.SurfelParams(*(
            torch.from_numpy(np.array(d[f"{prefix}_{n}"], np.float32)).to(
                dev) for n in S.SurfelParams._fields))

    for mid in range(manifest["n_models"]):
        d = np.load(directory / f"model_{mid:04d}.npz")
        model = LocalModel(slam.cfg, device=dev)
        model.world_T_model = d["world_T_model"]
        model.surfels = S.Surfels(
            params=params(d, "param"),
            active=torch.from_numpy(np.array(d["active"], bool)).to(dev))
        model.adam = S.AdamState(
            mu=params(d, "mu"), nu=params(d, "nu"),
            step=S.adam_step_count(int(d["adam_step"]), dev))
        for k in range(int(d["n_keyframes"][0])):
            model.keyframes.append(_frame_from_arrays(d, f"kf{k}", dev))
        slam.local_models.append(model)
    # frames list only tracks count + timestamps for the writer; keyframes
    # carry the cameras.  Rebuild slam.frames as the keyframe set.
    slam.frames = [kf for m in slam.local_models for kf in m.keyframes]
    slam.frames = slam.frames[:manifest["n_frames_processed"]] \
        if len(slam.frames) >= manifest["n_frames_processed"] else \
        slam.frames + [slam.frames[-1]] * (manifest["n_frames_processed"]
                                           - len(slam.frames))
    last = slam.local_models[-1]
    slam.mapper.register_model(last)
    slam.tracker.register_model(last)
    slam.tracker.register_keyframe(last.keyframes[-1])
    slam.tracker.keyframe_T_frame = np.load(
        directory / "keyframe_T_frame.npy")
    logger.info(f"checkpoint restored: {manifest['n_frames_processed']} "
                f"frames, {manifest['n_models']} submaps")
    return manifest["n_frames_processed"]
