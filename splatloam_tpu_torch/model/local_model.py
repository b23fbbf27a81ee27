"""LocalModel: one bounded submap = surfel pool + keyframes + origin pose.

Counterpart of splatloam_tpu/model/local_model.py: capacity doubling for
the fixed-capacity surfel pool and a keyframe stack on the device, padded
to bucket multiples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Configuration
from ..device import resolve_device
from ..logging_utils import get_logger
from .frame import Frame
from . import surfels as S

logger = get_logger("local_model")


class LocalModel:
    def __init__(self, cfg: Configuration, device=None):
        """``device``: None -> cuda (raises without a GPU)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.keyframes: list[Frame] = []
        self.world_T_model = np.eye(4, dtype=np.float64)
        cap = int(cfg.compute.initial_capacity)
        self.surfels = S.empty_surfels(cap, self.device)
        self.adam = S.empty_adam(cap, self.device)
        self.kf_stack: dict | None = None

    def insert_keyframe(self, frame: Frame) -> None:
        self.keyframes.append(frame)
        if self.kf_stack is None and len(self.keyframes) > 1:
            # keyframes restored without a stack (load_checkpoint): stage
            # them all, not only the new one
            self.rebuild_kf_stack()
        else:
            self._append_kf_stack(frame)

    def _append_kf_stack(self, frame: Frame) -> None:
        """Incremental keyframe stack on the device, grown by buckets of
        ``compute.keyframe_capacity``."""
        cam = frame.camera_in_model()
        bucket = max(int(self.cfg.compute.keyframe_capacity), 1)
        idx = len(self.keyframes) - 1
        if self.kf_stack is None or idx >= self.kf_stack["K"].shape[0]:
            cap = ((idx + bucket) // bucket) * bucket
            f32 = dict(dtype=torch.float32, device=self.device)
            new = {
                "K": torch.zeros((cap, 3, 3), **f32),
                "T_cw": torch.zeros((cap, 4, 4), **f32),
                "depth": torch.zeros((cap, cam.height, cam.width), **f32),
                "valid": torch.zeros((cap, cam.height, cam.width),
                                     dtype=torch.bool, device=self.device),
            }
            if self.kf_stack is not None:
                old_n = self.kf_stack["K"].shape[0]
                for k, v in new.items():
                    v[:old_n] = self.kf_stack[k]
            self.kf_stack = new
        for k, v in (("K", cam.K), ("T_cw", cam.T_cw), ("depth", cam.depth),
                     ("valid", cam.valid)):
            self.kf_stack[k][idx] = v.to(self.device)

    def rebuild_kf_stack(self) -> None:
        """Re-stage all keyframes."""
        self.kf_stack = None
        frames = list(self.keyframes)
        self.keyframes = []
        for f in frames:
            self.keyframes.append(f)
            self._append_kf_stack(f)

    def require_new_model(self) -> bool:
        """Submap rollover predicate."""
        thr_g = self.cfg.mapping.lmodel_threshold_ngaussians
        thr_k = self.cfg.mapping.lmodel_threshold_nkeyframes
        ret = False
        if thr_g and thr_g > 0:
            ret = ret or (self.no_gaussians > thr_g)
        if thr_k and thr_k > 0:
            ret = ret or (len(self.keyframes) > thr_k)
        return ret

    def ensure_free_slots(self, needed: int) -> None:
        """Double capacity until `needed` free slots exist."""
        free = self.capacity - self.no_gaussians
        if free >= needed:
            return
        new_cap = self.capacity
        while new_cap - self.no_gaussians < needed:
            new_cap *= 2
        max_cap = self.cfg.mapping.lmodel_threshold_ngaussians
        if max_cap and max_cap > 0:
            # a bit of headroom over the rollover threshold is fine; cap
            # runaway growth at 2x the threshold
            new_cap = min(new_cap, max(2 * int(max_cap), self.capacity))
        if new_cap > self.capacity:
            logger.info(f"growing surfel capacity {self.capacity} -> "
                        f"{new_cap}")
            self.surfels, self.adam = S.grow_capacity(
                self.surfels, self.adam, new_cap)

    @property
    def capacity(self) -> int:
        return self.surfels.capacity

    @property
    def no_gaussians(self) -> int:
        return int(self.surfels.num_active)

    @property
    def size_mb(self) -> float:
        # (3+4+2+1) float32 per surfel
        return (10 * 4 * self.no_gaussians) / (1024.0 ** 2)
