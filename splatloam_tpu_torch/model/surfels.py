"""Fixed-capacity surfel parameter store with a masked Adam optimizer.

Counterpart of splatloam_tpu/model/surfels.py.  The pool is a padded
[capacity] set of tensors with an ``active`` mask:

  * densify = write new params into free slots + zero their Adam moments
  * prune   = clear mask bits (the slot is recycled by a later densify)
  * growth  = capacity doubling

Parameterization: xyz [C,3]; log-scale [C,2] (exp activation); wxyz
quaternion [C,4] (normalized on use); logit opacity [C] (sigmoid
activation).  Adam uses per-field learning rates with eps=1e-15 and one
global step count, a 0-d int32 tensor on the pool's device as in the JAX
package, so that an Adam step reads nothing from the host (a captured
CUDA graph replays it with the step it finds there).  Every function
returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SurfelParams(NamedTuple):
    """The trainable leaves (everything Adam touches)."""
    xyz: torch.Tensor            # [C, 3]
    log_scale: torch.Tensor      # [C, 2]
    quat: torch.Tensor           # [C, 4] wxyz
    logit_opacity: torch.Tensor  # [C]


class Surfels(NamedTuple):
    params: SurfelParams
    active: torch.Tensor         # [C] bool

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.params.log_scale)

    @property
    def opacity(self) -> torch.Tensor:
        """Activated opacity, already masked by ``active``."""
        return torch.sigmoid(self.params.logit_opacity) * self.active

    @property
    def rotation(self) -> torch.Tensor:
        return self.params.quat  # normalized inside quat_to_rotmat

    @property
    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active)


class AdamState(NamedTuple):
    mu: SurfelParams
    nu: SurfelParams
    step: torch.Tensor           # [] int32, on the pool's device


class AdamHyper(NamedTuple):
    """Per-field learning rates + shared Adam constants."""
    lr_xyz: float = 5e-4
    lr_scale: float = 5e-3
    lr_quat: float = 1e-3
    lr_opacity: float = 5e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15


def inverse_sigmoid(x: float) -> float:
    """logit of a probability, rounded to float32 as the pool stores it."""
    return float(np.log(np.float32(x / (1.0 - x))))


def empty_surfels(capacity: int, device) -> Surfels:
    f32 = dict(dtype=torch.float32, device=device)
    quat = torch.zeros((capacity, 4), **f32)
    quat[:, 0] = 1.0
    params = SurfelParams(
        xyz=torch.zeros((capacity, 3), **f32),
        log_scale=torch.zeros((capacity, 2), **f32),
        quat=quat,
        logit_opacity=torch.full((capacity,), -10.0, **f32))
    return Surfels(params=params,
                   active=torch.zeros((capacity,), dtype=torch.bool,
                                      device=device))


def empty_adam(capacity: int, device) -> AdamState:
    def zeros():
        return SurfelParams(*(torch.zeros_like(a) for a in
                              empty_surfels(capacity, device).params))
    return AdamState(mu=zeros(), nu=zeros(), step=adam_step_count(0, device))


def adam_step_count(step: int, device) -> torch.Tensor:
    """Adam's step count as the state holds it: a 0-d int32 tensor."""
    return torch.tensor(step, dtype=torch.int32, device=device)


def adam_step(surfels: Surfels, state: AdamState, grads: SurfelParams,
              hyper: AdamHyper) -> tuple[Surfels, AdamState]:
    """One masked Adam update; inactive slots are left untouched."""
    step = state.step + 1
    # bias corrections on the device in float32, as the JAX package's
    t = step.to(torch.float32)
    c1 = 1.0 - hyper.b1 ** t
    c2 = 1.0 - hyper.b2 ** t
    lrs = SurfelParams(xyz=hyper.lr_xyz, log_scale=hyper.lr_scale,
                       quat=hyper.lr_quat, logit_opacity=hyper.lr_opacity)
    active = surfels.active

    def upd(p, g, m, v, lr):
        mask = active.reshape((-1,) + (1,) * (p.ndim - 1))
        g = torch.where(mask, g, 0.0)
        m = hyper.b1 * m + (1 - hyper.b1) * g
        v = hyper.b2 * v + (1 - hyper.b2) * g * g
        update = lr * (m / c1) / (torch.sqrt(v / c2) + hyper.eps)
        return p - torch.where(mask, update, 0.0), m, v

    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(surfels.params, grads, state.mu, state.nu,
                              lrs):
        p2, m2, v2 = upd(p, g, m, v, lr)
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    return (Surfels(params=SurfelParams(*new_p), active=active),
            AdamState(mu=SurfelParams(*new_m), nu=SurfelParams(*new_v),
                      step=step))


def insert_surfels(surfels: Surfels, state: AdamState,
                   new_params: SurfelParams, n_new
                   ) -> tuple[Surfels, AdamState, torch.Tensor]:
    """Write up to n_new rows of new_params into free slots (lowest free
    indices first).  New slots get zeroed Adam moments; the global step
    count is kept.  Returns (surfels, adam_state, n_written)."""
    cap = surfels.capacity
    dev = surfels.active.device
    m = new_params.xyz.shape[0]
    if m > cap:  # drop overflow rows beyond capacity
        new_params = SurfelParams(*(a[:cap] for a in new_params))
        m = cap
    order = torch.sort(surfels.active.to(torch.int32), stable=True).indices
    slots = order[:m]
    n_free = cap - torch.sum(surfels.active)
    n_new = torch.as_tensor(n_new, device=dev)
    n_write = torch.minimum(torch.minimum(n_new, n_free),
                            torch.tensor(m, device=dev))
    write = torch.arange(m, device=dev) < n_write

    def scatter(dst, src):
        mask = write.reshape((-1,) + (1,) * (dst.ndim - 1))
        out = dst.clone()
        out[slots] = torch.where(mask, src.to(dst.dtype), dst[slots])
        return out

    params = SurfelParams(*(scatter(d, s)
                            for d, s in zip(surfels.params, new_params)))
    active = surfels.active.clone()
    active[slots] = write | surfels.active[slots]

    def zero_moments(mo):
        mask = write.reshape((-1,) + (1,) * (mo.ndim - 1))
        out = mo.clone()
        out[slots] = torch.where(mask, 0.0, mo[slots])
        return out

    mu = SurfelParams(*(zero_moments(a) for a in state.mu))
    nu = SurfelParams(*(zero_moments(a) for a in state.nu))
    return (Surfels(params=params, active=active),
            AdamState(mu=mu, nu=nu, step=state.step), n_write)


def prune_surfels(surfels: Surfels, prune_mask: torch.Tensor) -> Surfels:
    """Deactivate slots."""
    return surfels._replace(active=surfels.active & ~prune_mask)


def grow_capacity(surfels: Surfels, state: AdamState, new_capacity: int
                  ) -> tuple[Surfels, AdamState]:
    """Capacity growth (pad with inactive slots)."""
    old = surfels.capacity
    if new_capacity < old:
        raise ValueError(f"cannot shrink the pool {old} -> {new_capacity}")
    if new_capacity == old:
        return surfels, state
    dev = surfels.active.device
    fresh = empty_surfels(new_capacity, dev)
    params = SurfelParams(*(torch.cat([a, b[old:]]) for a, b in
                            zip(surfels.params, fresh.params)))
    active = torch.cat([surfels.active, fresh.active[old:]])

    def padz(a):
        return torch.cat([a, a.new_zeros((new_capacity - old,)
                                         + a.shape[1:])])

    return (Surfels(params=params, active=active),
            AdamState(mu=SurfelParams(*(padz(a) for a in state.mu)),
                      nu=SurfelParams(*(padz(a) for a in state.nu)),
                      step=state.step))


def create_from_cloud(xyz: torch.Tensor, normals: torch.Tensor,
                      capacity: int, max_scale: float = 0.5
                      ) -> tuple[Surfels, AdamState]:
    """Bootstrap a surfel pool on ``xyz``'s device from an oriented point
    cloud: scales from the 3-NN mean square distance clamped to
    max_scale^2, rotations aligning the surfel normal axis to the given
    normals, opacity sigma^-1(0.9)."""
    from ..geometry import se3
    from ..ops import knn

    dev = xyz.device
    n = xyz.shape[0]
    surf = empty_surfels(capacity, dev)
    adam = empty_adam(capacity, dev)
    xyz = xyz.to(torch.float32)
    d2 = torch.clamp(knn.mean_sq_dist_knn(xyz), 1e-7, max_scale ** 2)
    log_scale = (0.5 * torch.log(d2))[:, None].repeat(1, 2)
    quat = se3.quat_from_normal(normals.to(torch.float32))
    params = SurfelParams(
        xyz=xyz, log_scale=log_scale, quat=quat,
        logit_opacity=torch.full((n,), inverse_sigmoid(0.9),
                                 dtype=torch.float32, device=dev))
    surf, adam, _ = insert_surfels(surf, adam, params, n)
    return surf, adam


def compact_arrays(surfels: Surfels) -> dict[str, np.ndarray]:
    """Active rows as numpy (for PLY export etc.)."""
    idx = torch.nonzero(surfels.active).reshape(-1)
    return {name: getattr(surfels.params, name)[idx].detach().cpu().numpy()
            for name in SurfelParams._fields}

