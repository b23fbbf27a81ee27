"""Ring alpha-compositing over depth-partitioned surfel shards.

Counterpart of splatloam_tpu/parallel/ring.py.  When the surfel pool is
split over the "model" ranks by camera depth, each rank renders only its
depth band, and front-to-back alpha blending is associative over
depth-contiguous SEGMENTS: a segment's effect on a pixel is the pair
(T_seg = prod(1-a_i), S_seg = sum_i w_i * payload_i), and two segments
combine as

    S = S_front + T_front * S_back,      T = T_front * T_back.

The depth-distortion channel folds too: with A = sum w (alpha), D =
sum w*m (depth_sum) per segment,

    dist = dist_f + T_f * (A_f * D_b - D_f * A_b) + T_f^2 * dist_b.

The median channel is not folded (no loss of the ring paths reads it), so
the ring paths require depth_ratio == 0, as in the JAX package.

The fold: JAX rotates the segment states one ppermute hop at a time and
broadcasts rank 0's composite with a masked psum.  Here every rank
all-gathers the bands' segment states (the same (n-1) x image x 6 floats
sent per rank as the n-1 hops) and folds them locally in band order, so
every rank ends with the composite and no broadcast follows; the
backward is the all-gather's reduce-scatter.

Early exit.  The kernel path stops a tile once every pixel's
transmittance is <= T_EPS (ops/rasterizer/common.py).  A band renders
from T = 1, so behind an opaque front band the fold still adds
T_front * S_back, which the single render drops, and a band may drop
slots the single render keeps.  Either set of dropped slots carries a
pixel weight of at most T_EPS in all, so wherever the gap can appear
(min of the two final T at most T_EPS) it is bounded per pixel by
T_EPS in alpha and T, T_EPS in each normal component, and T_EPS x the
largest splat depth in depth_sum (``early_exit_bound``); elsewhere the two
agree to float rounding, where the bands list the same slots as the whole
pool.  They need not: each band bins alone, and the sorted binner's
budgets of wide splats (binning._emit_sorted_keys) and the list capacity
apply per band, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..model import surfels as S
from ..ops.rasterizer.api import RenderParams, rasterize
from ..ops.rasterizer.common import T_EPS
from . import collectives as C

STATE_WIDTH = 31   # floats in one packed (params, active, mu, nu) row


def ring_combine(front: dict, back: dict) -> dict:
    """Associative combine of two depth-adjacent segment states.

    Keys: "T" transmittance, "alpha", "depth_sum", "normal_sum" (trailing
    [3]), optional "dist"."""
    out = dict(
        T=front["T"] * back["T"],
        depth_sum=front["depth_sum"] + front["T"] * back["depth_sum"],
        alpha=front["alpha"] + front["T"] * back["alpha"],
        normal_sum=front["normal_sum"]
        + front["T"][..., None] * back["normal_sum"],
    )
    if "dist" in front:
        out["dist"] = (front["dist"]
                       + front["T"] * (front["alpha"] * back["depth_sum"]
                                       - front["depth_sum"] * back["alpha"])
                       + front["T"] ** 2 * back["dist"])
    return out


def _seg_to_tensor(seg: dict) -> torch.Tensor:
    parts = [seg["T"][..., None], seg["depth_sum"][..., None],
             seg["alpha"][..., None], seg["normal_sum"]]
    if "dist" in seg:
        parts.append(seg["dist"][..., None])
    return torch.cat(parts, dim=-1)


def _tensor_to_seg(x: torch.Tensor, with_dist: bool) -> dict:
    seg = dict(T=x[..., 0], depth_sum=x[..., 1], alpha=x[..., 2],
               normal_sum=x[..., 3:6])
    if with_dist:
        seg["dist"] = x[..., 6]
    return seg


def ring_fold(seg: dict, group) -> dict:
    """Fold the group's segment states front to back; group rank d must
    hold depth band d (ascending).  Every rank returns the composite of
    bands [0..n-1].  Differentiable: the all-gather's backward
    reduce-scatters each band's cotangent back to its rank."""
    x = _seg_to_tensor(seg)
    n = group.size
    bands = C.all_gather(x[None], group)            # [n, ..., 6 or 7]
    with_dist = "dist" in seg
    acc = _tensor_to_seg(bands[0], with_dist)
    for b in range(1, n):
        acc = ring_combine(acc, _tensor_to_seg(bands[b], with_dist))
    return acc


def _pack_state_rows(params: S.SurfelParams, active, mu: S.SurfelParams,
                     nu: S.SurfelParams) -> torch.Tensor:
    """Stack (params, active, Adam moments) into [rows, 31] float rows, so
    one exchange moves a slot's entire state."""
    def cat(p):
        return [p.xyz, p.log_scale, p.quat, p.logit_opacity[:, None]]
    return torch.cat(cat(params) + [active.to(torch.float32)[:, None]]
                     + cat(mu) + cat(nu), dim=1)


def _unpack_state_rows(rows: torch.Tensor):
    def take(base):
        return S.SurfelParams(
            xyz=rows[:, base:base + 3],
            log_scale=rows[:, base + 3:base + 5],
            quat=rows[:, base + 5:base + 9],
            logit_opacity=rows[:, base + 9])
    return take(0), rows[:, 10] > 0.5, take(11), take(21)


def ring_reshard(surf: S.Surfels, st: S.AdamState, d_key: torch.Tensor,
                 group):
    """Depth-contiguous re-partition of a "model"-sharded pool without
    materialising it: only the depth keys are all-gathered (4 bytes a
    slot); each slot's packed 31-float state row goes straight to its
    destination band in one bucketed all-to-all.

    Rank m ends holding exactly the slots whose global depth rank lies in
    [m*rows, (m+1)*rows), in rank order — the layout of all-gathering the
    pool and slicing its stable depth argsort, as in the JAX package.
    Every rank sorts the same gathered keys, so each knows what it sends
    (its slots by destination band) and what it receives (the band's
    slots by source rank) without exchanging the counts."""
    rows = d_key.shape[0]
    me, n = group.rank, group.size
    d_full = C.all_gather_raw(d_key, group)
    perm = torch.sort(d_full, stable=True).indices        # rank -> slot
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    my_rank = inv[me * rows:(me + 1) * rows]               # of my slots
    send_order = torch.sort(my_rank).indices               # by rank
    dest = my_rank[send_order] // rows
    band = perm[me * rows:(me + 1) * rows]                 # my band's slots
    src = band // rows
    in_splits = torch.bincount(dest, minlength=n).tolist()
    out_splits = torch.bincount(src, minlength=n).tolist()

    packed = _pack_state_rows(surf.params, surf.active, st.mu, st.nu)
    recv = C.all_to_all(packed[send_order], in_splits, out_splits, group)
    # received rows come source by source, each source's in rank order
    recv_order = torch.sort(src, stable=True).indices
    out = torch.empty_like(recv)
    out[recv_order] = recv
    params2, active2, mu2, nu2 = _unpack_state_rows(out)
    return (S.Surfels(params=params2, active=active2),
            S.AdamState(mu=mu2, nu=nu2, step=st.step))


def depth_partition_shards(surfels: S.Surfels, T_cw: torch.Tensor,
                           n_shards: int) -> torch.Tensor:
    """Per-view depth bucketing: a [C] permutation placing the pool in
    ascending camera-depth order, inactive slots last, so an even split
    into n_shards yields depth-contiguous buckets."""
    cap = surfels.capacity
    xyz_h = torch.cat([surfels.params.xyz,
                       surfels.params.xyz.new_ones((cap, 1))], dim=1)
    depth = torch.linalg.norm((xyz_h @ T_cw.T)[:, :3], dim=-1)
    key = torch.where(surfels.active, depth, float("inf"))
    return torch.sort(key, stable=True).indices


def _shard_channels(params_shard: S.SurfelParams, active_shard, T_cw, K,
                    params: RenderParams, with_dist: bool) -> dict:
    """Render ONE depth band -> its segment state dict: on the cuda
    backend through the kernel path (channel 7 of K1's output is final
    T), on eager through the golden renderer."""
    scaling = torch.exp(params_shard.log_scale)
    opacity = torch.sigmoid(params_shard.logit_opacity) * active_shard
    chans = rasterize(params_shard.xyz, scaling, params_shard.quat, opacity,
                      T_cw, K, params._replace(with_median=False,
                                               with_dist=with_dist))
    seg = dict(T=chans["final_T"], depth_sum=chans["depth_sum"],
               alpha=chans["alpha"], normal_sum=chans["normal_sum"])
    if with_dist:
        seg["dist"] = chans["dist"]
    return seg


def ring_render(mesh, params: RenderParams, with_dist: bool = False):
    """A ring-composited renderer over the mesh's "model" axis:
    fn(params_shard, active_shard, T_cw, K) -> channel dict (T,
    depth_sum, alpha, normal_sum[, dist]) of the whole pool, on every
    rank.  Model rank d passes depth band d of the pool (permuted depth
    ascending, e.g. by depth_partition_shards).  A rank's gradient is
    that of the sum of every rank's loss, so a loss that each model rank
    computes on the composite counts once when divided by the axis size,
    as sharded_optimize_ring does."""
    group = mesh.group("model")

    def fn(params_shard: S.SurfelParams, active_shard, T_cw, K) -> dict:
        seg = _shard_channels(params_shard, active_shard, T_cw, K, params,
                              with_dist)
        return ring_fold(seg, group)

    return fn


def early_exit_bound(max_depth: float) -> dict:
    """Per-pixel bound of the ring's gap to the single render where
    either final T is at most T_EPS (module docstring)."""
    return {"alpha": T_EPS, "T": T_EPS, "normal_sum": T_EPS,
            "depth_sum": T_EPS * float(max_depth)}
