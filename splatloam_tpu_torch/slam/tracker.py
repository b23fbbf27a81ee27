"""Tracker: frame-to-rendered-model registration.

Counterpart of splatloam_tpu/slam/tracker.py, a projective Gauss-Newton
scan registration:

  target  = model depth *rendered* at the last keyframe's view (the
            forward kernel K1 under ``torch.no_grad``), back-projected to
            points + finite-difference normals, in the keyframe's frame;
  source  = measured depth of the new frame, back-projected;
  residual r_i = n_t . (T p_s - p_t)  via nearest-pixel projective data
            association, Huber-robustified;  update T <- exp(dx) T from
            the damped 6x6 normal equations;  fitness = inlier fraction.

The GN loop reads nothing back to the host: where the JAX package exits
its ``while_loop`` once |dx| <= convergence_tol, this loop runs all
``num_iterations`` and carries an ``active`` flag on the device, which
freezes T after the step that met the tolerance: the same answer, with
no synchronization per iteration.  The pose algebra of the caller stays
on the host in float64; ``align`` uploads one float32 4x4 and reads T and
the fitness back once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import AlignerParams, Configuration, TrackingMethod
from ..device import resolve_device
from ..geometry import se3, spherical
from ..logging_utils import get_logger
from ..model.frame import Frame
from ..model.local_model import LocalModel
from ..ops.rasterizer.api import RenderParams, render
from ..profiling import get_profiler

logger = get_logger("tracker")


def _prepare_target(xyz, scaling, rotation, opacity, T_cw, K,
                    params: RenderParams, depth_min: float,
                    depth_ratio: float):
    """Render the model at the keyframe view and derive the registration
    target: (depth [H, W], points [H, W, 3], normals [H, W, 3],
    valid [H, W])."""
    with torch.no_grad():
        pkg = render(xyz, scaling, rotation, opacity, T_cw, K, params,
                     depth_ratio)
        depth = pkg["surf_depth"]
        valid = (pkg["rend_alpha"] > 0.5) & (depth > depth_min)
        pts = spherical.depth_to_points(depth, K)
        normals = spherical.depth_to_normal(depth, K)
    return depth, pts, normals, valid


def _prepare_source(depth, K, valid):
    pts = spherical.depth_to_points(depth, K).reshape(-1, 3)
    return pts, valid.reshape(-1)


def _corr_at(i: int, max_corr_dist: float, corr_factor_init: float,
             corr_decay_iters: int) -> float:
    """The correspondence gate of iteration i, in float32 as the JAX
    package computes it."""
    if corr_decay_iters <= 0 or corr_factor_init <= 1.0:
        return float(np.float32(max_corr_dist))
    f32 = np.float32
    frac = min(f32(i) / f32(corr_decay_iters), f32(1.0))
    factor = f32(corr_factor_init) + f32(1.0 - corr_factor_init) * frac
    return float(f32(max_corr_dist) * f32(factor))


def gauss_newton_align(T_init,
                       src_pts, src_valid,
                       tgt_depth, tgt_pts, tgt_normals, tgt_valid,
                       K,
                       height: int, width: int,
                       num_iterations: int,
                       huber_delta: float,
                       max_corr_dist: float,
                       inlier_threshold: float,
                       damping: float,
                       corr_factor_init: float = 1.0,
                       corr_decay_iters: int = 0,
                       convergence_tol: float = 0.0,
                       lambda_range: float = 0.0):
    """Projective point-to-plane GN; all target images [H, W, ...], all
    tensors on one device.  Returns (T [4, 4], fitness []) as tensors on
    that device; nothing is read back to the host.

    The correspondence gate starts at corr_factor_init * max_corr_dist and
    decays linearly to 1x over corr_decay_iters; T stops moving after the
    first step with |dx| <= convergence_tol (when > 0).  A failed solve
    (non-finite dx, or fewer than 6 correspondences) leaves T as it is and
    does not count as converged.  ``lambda_range > 0`` adds the range
    residual |T p_s| - rendered_range(pixel), Jacobian [q_hat, 0].
    """
    # flat single-index gathers
    tgt_n_flat = tgt_normals.reshape(-1, 3)
    tgt_p_flat = tgt_pts.reshape(-1, 3)
    tgt_v_flat = tgt_valid.reshape(-1)
    tgt_d_flat = tgt_depth.reshape(-1)
    dev = T_init.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def residuals(T, corr_dist):
        q = src_pts @ T[:3, :3].T + T[:3, 3]
        x, y, _ = spherical.project_points(K, q)
        u = torch.remainder(spherical.pixel_index(x), width)
        v = spherical.pixel_index(y)
        in_img = (v >= 0) & (v < height)
        flat = (torch.clamp(v, 0, height - 1) * width + u).long()
        n = tgt_n_flat.index_select(0, flat)
        p_t = tgt_p_flat.index_select(0, flat)
        tv = tgt_v_flat.index_select(0, flat)
        r = torch.sum(n * (q - p_t), dim=-1)
        base = src_valid & in_img & tv
        ok = base & (torch.abs(r) <= corr_dist)
        r_rng = torch.linalg.norm(q, dim=-1) - \
            tgt_d_flat.index_select(0, flat)
        ok_rng = base & (torch.abs(r_rng) <= corr_dist)
        return r, ok, q, n, r_rng, ok_rng

    def huber(absr):
        return torch.where(absr <= huber_delta, 1.0,
                           huber_delta / torch.clamp(absr, min=1e-12))

    T = T_init
    active = torch.ones((), dtype=torch.bool, device=dev)
    for i in range(num_iterations):
        corr = _corr_at(i, max_corr_dist, corr_factor_init, corr_decay_iters)
        r, ok, q, n, r_rng, ok_rng = residuals(T, corr)
        w = torch.where(ok, huber(torch.abs(r)), 0.0)
        J = torch.cat([n, torch.linalg.cross(q, n, dim=-1)], dim=-1)
        H = (J * w[:, None]).T @ J
        b = J.T @ (w * r)
        if lambda_range > 0.0:
            # range channel: J2 = [q_hat, 0] (rotation leaves |q| fixed)
            q_hat = q / torch.clamp(torch.linalg.norm(q, dim=-1,
                                                      keepdim=True),
                                    min=1e-9)
            w2 = torch.where(ok_rng, lambda_range * huber(torch.abs(r_rng)),
                             0.0)
            J2 = torch.cat([q_hat, torch.zeros_like(q_hat)], dim=-1)
            H = H + (J2 * w2[:, None]).T @ J2
            b = b + J2.T @ (w2 * r_rng)
        H = H + damping * eye6
        # solve_ex leaves info on the device: a singular H reads as a
        # failed solve below instead of raising on the host
        sol, info = torch.linalg.solve_ex(H, b, check_errors=False)
        dx = -sol
        ok_solve = torch.all(torch.isfinite(dx)) & (info == 0) & \
            (torch.sum(ok) >= 6)
        dx = torch.where(ok_solve, dx, 0.0)
        # a failed solve must not read as converged: its |dx| is +inf
        dx_norm = torch.where(ok_solve, torch.linalg.norm(dx), float("inf"))
        T = torch.where(active, se3.exp_se3(dx) @ T, T)
        if convergence_tol > 0.0:
            active = active & (dx_norm > convergence_tol)
    r, ok, _, _, _, _ = residuals(T, float(np.float32(max_corr_dist)))
    n_src = torch.clamp(torch.sum(src_valid), min=1)
    fitness = torch.sum(ok & (torch.abs(r) < inlier_threshold)) / n_src
    return T, fitness


class AlignerGN:
    """Gauss-Newton scan-to-model aligner (``tracking.method``
    gsaligner)."""

    def __init__(self, cfg: Configuration, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.reg_fitness = 1.0
        self.model: LocalModel | None = None
        ap = cfg.tracking.gsaligner or AlignerParams()
        ap.image_height = cfg.preprocessing.image_height
        ap.image_width = cfg.preprocessing.image_width
        self.ap = ap
        self._target = None
        self._source = None

    def set_model(self, model: LocalModel) -> None:
        self.model = model

    def _params_for(self, cam) -> RenderParams:
        cc = self.cfg.compute
        cap = self.model.capacity if self.model is not None else 1 << 30
        k_eff = min(int(cc.tile_list_capacity),
                    max(int(cc.chunk), (cap // 8 // cc.chunk) * cc.chunk))
        return RenderParams(height=cam.height, width=cam.width,
                            backend=cc.backend.value, chunk=cc.chunk,
                            tile_h=cc.tile_h, tile_w=cc.tile_w,
                            tile_list_capacity=k_eff,
                            with_median=self.cfg.opt.depth_ratio > 0,
                            with_dist=False)

    def set_target(self, frame: Frame) -> None:
        """Render the model at the keyframe view."""
        assert self.model is not None
        cam = frame.camera_in_model()
        surf = self.model.surfels
        depth, pts, normals, valid = _prepare_target(
            surf.params.xyz, surf.scaling, surf.rotation, surf.opacity,
            cam.T_cw, cam.K, self._params_for(cam),
            float(self.cfg.preprocessing.depth_min),
            float(self.cfg.opt.depth_ratio))
        self._target = (depth, pts, normals, valid, cam.K,
                        cam.height, cam.width)

    def set_source(self, frame: Frame) -> None:
        """Measured depth of the new frame."""
        cam = frame.camera
        self._source = _prepare_source(cam.depth, cam.K, cam.valid)

    def align(self, iguess: np.ndarray) -> np.ndarray:
        """float64 [4, 4] initial guess -> float64 [4, 4] keyframe_T_frame;
        one upload of the guess and one read of (T, fitness)."""
        assert self._target is not None and self._source is not None
        depth, pts, normals, valid, K, h, w = self._target
        src_pts, src_valid = self._source
        T, fitness = gauss_newton_align(
            torch.as_tensor(np.asarray(iguess, np.float32),
                            device=self.device),
            src_pts, src_valid, depth, pts, normals, valid, K, h, w,
            num_iterations=int(self.ap.num_iterations),
            huber_delta=float(self.ap.huber_delta),
            max_corr_dist=float(self.ap.max_correspondence_dist),
            inlier_threshold=float(self.ap.inlier_threshold),
            damping=float(self.ap.damping),
            corr_factor_init=float(self.ap.corr_factor_init),
            corr_decay_iters=int(self.ap.corr_decay_iters),
            convergence_tol=float(self.ap.convergence_tol),
            lambda_range=float(self.ap.lambda_range or 0.0))
        out = torch.cat([T.reshape(-1), fitness.reshape(1)]).cpu().numpy()
        self.reg_fitness = float(out[16])
        return out[:16].reshape(4, 4).astype(np.float64)

    def fitness(self) -> float:
        return self.reg_fitness


class AlignerGT:
    """Ground-truth aligner: keyframe_T_frame from the frames' GT poses."""

    def __init__(self, cfg: Configuration, device=None):
        self.source = None
        self.target = None
        self.model = None

    def set_source(self, frame: Frame) -> None:
        self.source = frame

    def set_target(self, frame: Frame) -> None:
        self.target = frame

    def align(self, iguess: np.ndarray) -> np.ndarray:
        world_T_target = self.target.world_T_frame
        world_T_source = self.source.world_T_frame
        return np.linalg.inv(world_T_target) @ world_T_source

    def fitness(self) -> float:
        return 1.0

    def set_model(self, model: LocalModel) -> None:
        self.model = model


aligner_available = {
    TrackingMethod.gsaligner: AlignerGN,
    TrackingMethod.gt: AlignerGT,
}


class Tracker:
    """Frame-to-keyframe pose estimation.

    ``device``: None -> cuda (raises without a GPU).
    """

    def __init__(self, cfg: Configuration, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: LocalModel | None = None
        self.num_frames_tracked = 0
        self.keyframe_T_frame = np.eye(4, dtype=np.float64)
        self.aligner = aligner_available[cfg.tracking.method](
            cfg, device=self.device)

    def register_model(self, model: LocalModel) -> None:
        self.model = model
        self.num_frames_tracked = 0
        self.aligner.set_model(model)

    def register_keyframe(self, keyframe: Frame) -> None:
        self.keyframe_T_frame = np.eye(4, dtype=np.float64)
        self.aligner.set_target(keyframe)
        self.num_frames_tracked = 0

    def track(self, frame: Frame) -> None:
        prof = get_profiler()
        with prof.phase("track.set_source"):
            self.aligner.set_source(frame)
        with prof.phase("track.align"):
            self.keyframe_T_frame = self.aligner.align(
                self.keyframe_T_frame)
        model_T_keyframe = self.model.keyframes[-1].model_T_frame
        frame.model_T_frame = model_T_keyframe @ self.keyframe_T_frame
        self.num_frames_tracked += 1
        logger.debug(f"track| model_T_frame="
                     f"{frame.model_T_frame[:3, -1]}"
                     f" fitness={self.aligner.fitness():.3f}")

    def require_new_keyframe(self) -> bool:
        """Keyframe trigger: frame count, fitness, or distance from the
        keyframe above their thresholds."""
        tc = self.cfg.tracking
        ret = False
        if tc.keyframe_threshold_nframes and \
                tc.keyframe_threshold_nframes > 0:
            ret = ret or (self.num_frames_tracked >
                          tc.keyframe_threshold_nframes)
        if tc.keyframe_threshold_fitness and \
                tc.keyframe_threshold_fitness > 0:
            ret = ret or (self.aligner.fitness() <
                          tc.keyframe_threshold_fitness)
        if tc.keyframe_threshold_distance and \
                tc.keyframe_threshold_distance > 0:
            dist = np.linalg.norm(self.keyframe_T_frame[:3, 3])
            ret = ret or (dist > tc.keyframe_threshold_distance)
        return ret
