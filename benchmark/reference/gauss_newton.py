"""The plain reference of the tracker's Gauss-Newton solve: projective
point-to-plane registration of a sweep against the model rendered at the
keyframe, in float64 with TF32 off, in plain PyTorch.

A frozen copy of the math that ``splatloam_tpu_torch/slam/tracker.py``
(``gauss_newton_align``) states; it imports nothing of the port:

  association  each source point q = T p projects to its nearest pixel,
               u = floor(fx atan2(q_y, q_x) + cx + 1) mod W and
               v = floor(fy atan2(q_z, |q_xy|) + cy + 1), where it meets
               the target's normal n, point p_t and validity;
  residual     r = n . (q - p_t), kept where the source point and the
               target pixel are valid, v lies in the image and |r| is
               within the gate;
  gate         at iteration i, max_corr_dist (f + (1 - f) min(i / D, 1))
               with f = corr_factor_init and D = corr_decay_iters (just
               max_corr_dist when D <= 0 or f <= 1), worked out in
               float32 as the port states it;
  weights      Huber: 1 where |r| <= huber_delta, huber_delta / |r| above;
  step         J = [n, q x n], (J^T W J + damping I) s = J^T W r,
               dx = -s, T <- exp(dx) T (the twist (v, w), Rodrigues);
  failure      a step that is not finite, a singular system or fewer than
               6 kept residuals leave T as it is and do not count as
               converged;
  freeze       T moves no more after the first step with |dx| <=
               convergence_tol (when > 0), within num_iterations.

Departures from the port: float64 throughout (the port computes in
float32 and rounds the guess to float32 on upload); the loop stops at
the freeze instead of running every iteration with T held (the same T);
only the source points marked valid enter (the others carry no weight in
the port either); the fitness is not worked out (nothing compares it);
the port's optional range residual (``lambda_range`` > 0, which no
shipped configuration sets) is not frozen: ``settings`` refuses it.

``tf32``: the same in float32 with TF32 matrix products, their inputs
rounded to TF32's 10-bit mantissa (so that the CPU computes what the
card does): the precision below the float32 that the port states, the
control that the comparison has to fail.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

# the port's AlignerParams defaults (tracking.gsaligner left unset)
DEFAULTS = dict(num_iterations=30, huber_delta=0.3,
                max_correspondence_dist=1.0, damping=1e-6,
                corr_factor_init=3.0, corr_decay_iters=15,
                convergence_tol=1e-6)


def settings(cfg) -> dict:
    """The solver's settings as the configuration states them."""
    out = dict(DEFAULTS)
    given = cfg.tracking.gsaligner
    for key in DEFAULTS:
        value = getattr(given, key, None)
        if value is not None:
            out[key] = value
    if getattr(given, "lambda_range", None):
        raise ValueError("the plain solve has no range residual "
                         "(tracking.gsaligner.lambda_range)")
    return out


def gate(i: int, s: dict) -> float:
    """The correspondence gate of iteration ``i`` (float32 arithmetic)."""
    f32 = np.float32
    dist, init = s["max_correspondence_dist"], s["corr_factor_init"]
    decay = int(s["corr_decay_iters"])
    if decay <= 0 or init <= 1.0:
        return float(f32(dist))
    frac = min(f32(i) / f32(decay), f32(1.0))
    return float(f32(dist) * (f32(init) + f32(1.0 - init) * frac))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.contiguous().to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """[6] twist (v, w) -> [4, 4] rigid motion (Rodrigues, with the
    series below 1e-5 rad)."""
    v, w = xi[:3], xi[3:]
    th = torch.linalg.norm(w)
    W = torch.zeros((3, 3), dtype=xi.dtype, device=xi.device)
    W[0, 1], W[0, 2], W[1, 2] = -w[2], w[1], -w[0]
    W = W - W.T
    W2 = W @ W
    if float(th) < 1e-5:
        t2 = th * th
        a, b, c = 1 - t2 / 6, 0.5 - t2 / 24, 1 / 6 - t2 / 120
    else:
        a = torch.sin(th) / th
        b = (1 - torch.cos(th)) / (th * th)
        c = (th - torch.sin(th)) / (th * th * th)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    out = torch.eye(4, dtype=xi.dtype, device=xi.device)
    out[:3, :3] = eye + a * W + b * W2
    out[:3, 3] = (eye + b * W + c * W2) @ v
    return out


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def align(guess, src_pts, src_valid, tgt_depth, tgt_pts, tgt_normals,
          tgt_valid, K, s: dict, tf32: bool = False) -> torch.Tensor:
    """float64 [4, 4] keyframe_T_frame that the solve reaches from
    ``guess`` ([4, 4]); source points [N, 3] with their validity [N],
    the target's images [H, W(, 3)], K [3, 3], settings ``s``."""
    dt = torch.float32 if tf32 else torch.float64
    rnd = round_tf32 if tf32 else (lambda x: x)
    dev = src_pts.device
    height, width = tgt_depth.shape
    p = rnd(src_pts.reshape(-1, 3)[src_valid.reshape(-1)].to(dt))
    tn = tgt_normals.reshape(-1, 3).to(dt)
    tp = tgt_pts.reshape(-1, 3).to(dt)
    tv = tgt_valid.reshape(-1)
    fx, cx, fy, cy = (float(K[0, 0]), float(K[0, 2]), float(K[1, 1]),
                      float(K[1, 2]))
    delta, damping = float(s["huber_delta"]), float(s["damping"])
    tol = float(s["convergence_tol"])
    T = torch.as_tensor(np.asarray(guess), device=dev).to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def huber(a):
        return torch.where(a <= delta, 1.0,
                           delta / torch.clamp(a, min=1e-12))

    with _tf32(tf32):
        for i in range(int(s["num_iterations"])):
            corr = gate(i, s)
            q = p @ rnd(T[:3, :3]).T + T[:3, 3]
            theta = torch.atan2(q[:, 1], q[:, 0])
            phi = torch.atan2(q[:, 2], torch.hypot(q[:, 0], q[:, 1]))
            u = torch.remainder(torch.floor(fx * theta + cx + 1.0), width)
            v = torch.floor(fy * phi + cy + 1.0)
            inside = (v >= 0) & (v < height)
            flat = (torch.clamp(v, 0, height - 1) * width + u).long()
            n, pt = tn[flat], tp[flat]
            r = torch.sum(n * (q - pt), -1)
            ok = inside & tv[flat] & (torch.abs(r) <= corr)
            w = torch.where(ok, huber(torch.abs(r)), 0.0)
            J = rnd(torch.cat([n, torch.linalg.cross(q, n, dim=-1)], -1))
            H = rnd(J * w[:, None]).T @ J
            b = J.T @ (w * r)
            sol, info = torch.linalg.solve_ex(H + damping * eye6, b)
            dx = -sol
            if (int(info) != 0 or not bool(torch.isfinite(dx).all())
                    or int(ok.sum()) < 6):
                continue
            T = exp_se3(dx) @ T
            if tol > 0.0 and float(torch.linalg.norm(dx)) <= tol:
                break
    return T.to(torch.float64)


def point_gap(src_pts, src_valid, T_a, T_b) -> float:
    """The largest distance (m) between the valid source points moved by
    ``T_a`` and by ``T_b``."""
    p = src_pts.reshape(-1, 3)[src_valid.reshape(-1)].to(torch.float64)
    if not len(p):
        return math.inf
    d = (torch.as_tensor(T_a, dtype=torch.float64, device=p.device)
         - torch.as_tensor(T_b, dtype=torch.float64, device=p.device))
    return float(torch.linalg.norm(p @ d[:3, :3].T + d[:3, 3], dim=-1).max())
