"""Tiled rasterizer on the hand-written CUDA kernels (forward + backward).

Counterpart of splatloam_tpu/ops/rasterizer/pallas_raster.py, tiled layout
and one view only:

  * binning.py produces depth-ordered per-tile surfel lists (torch ops);
  * the forward kernel (K1) composites each tile's chunks front to back and
    saves every chunk's start transmittance;
  * the backward kernel (K2) replays the live chunks in reverse with O(P)
    suffix carries and writes per-slot feature-gradient rows;
  * the rows reduce to per-surfel gradients by the rank-space segmented
    sum (K3, ``scatter="ranksum"``) or by an atomic scatter-add (K4,
    ``scatter="rmw"``);
  * gradients reach the surfel params and the pose through torch autograd
    of ``pack_surfels``.

The kernels gather their features from F [N+1, 16] by the tile lists
themselves, so the JAX package's separate feature gather (and its [T, 16,
K] copy kept for the backward) has no counterpart here.  On CPU tensors
every kernel wrapper runs its plain PyTorch version (kernels.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import binning, common, kernels

# ranksum plan geometry: entries per group and groups per step (the plan's
# padding unit); fixed so the plan equals the JAX package's
RS_GROUP = 128
RS_GPS = 64
SCATTER_MODES = ("rmw", "ranksum")


class RanksumPlan(NamedTuple):
    """Rebin-time id-sort for the rank-space segmented-sum reduction
    (binning.build_ranksum_plan)."""
    pos: torch.Tensor         # [E] int32 flat slot position, id-sorted
    ranks: torch.Tensor       # [E] int32 dense rank of the entry's id (pad -1)
    w_first: torch.Tensor     # [E/group] int32 first rank of each group
    rank_of_id: torch.Tensor  # [N+1] int32 rank row per id (absent -> dummy)


class TileAssignment(NamedTuple):
    """Frozen binning state, reusable across optimization iterations (the
    mapper rebins every ``compute.rebin_every`` steps with a pixel margin
    on the binning radius to absorb parameter drift)."""
    lists: torch.Tensor    # [T, K] int32
    counts: torch.Tensor   # [T] int32
    rays_t: torch.Tensor   # [T, P, 3]
    pix_t: torch.Tensor    # [T, P, 2]
    plan: RanksumPlan | None = None   # None -> the scatter-add reduction


class _StaticArgs(NamedTuple):
    chunk: int
    width: int
    with_median: bool
    with_dist: bool


def _check_params(params) -> None:
    if params.height % params.tile_h or params.width % params.tile_w:
        raise ValueError(f"image {params.height}x{params.width} not "
                         f"divisible by tile {params.tile_h}x{params.tile_w}")
    if params.tile_list_capacity % params.chunk:
        raise ValueError("tile_list_capacity must be a chunk multiple")
    if params.scatter not in SCATTER_MODES:
        raise ValueError(f"unknown scatter mode {params.scatter!r}; the "
                         f"port has {SCATTER_MODES}")


def prepare_tiles(xyz, scaling, rotation, opacity, T_cw, K, params,
                  margin_px: float = 0.0) -> TileAssignment:
    """Binning only (no gradients): depth sort + tile lists + rays, plus
    the ranksum plan when ``params.scatter == "ranksum"``."""
    _check_params(params)
    height, width = params.height, params.width
    tile_h, tile_w = params.tile_h, params.tile_w
    with torch.no_grad():
        packed = common.pack_surfels(xyz, scaling, rotation, opacity,
                                     T_cw, K)
        if margin_px > 0:
            packed.radius_px = torch.where(packed.radius_px > 0,
                                           packed.radius_px + margin_px, 0.0)
            packed.extent_px = torch.where(packed.extent_px > 0,
                                           packed.extent_px + margin_px, 0.0)
        rays_all, pix_all = binning.tile_rays(K, height, width, tile_h,
                                              tile_w)
        if params.binner == "sorted":
            lists, counts, _ = binning.build_tile_lists_sorted(
                packed, height, width, tile_h, tile_w,
                params.tile_list_capacity, params.cap_ty, params.cap_tx)
        elif params.binner == "exact":
            lists, counts, _ = binning.build_tile_lists(
                packed, height, width, tile_h, tile_w,
                params.tile_list_capacity)
        else:
            raise ValueError(f"unknown binner {params.binner!r}")
        plan = None
        if params.scatter == "ranksum":
            plan = RanksumPlan(*binning.build_ranksum_plan(
                lists, xyz.shape[0], group=RS_GROUP, gps=RS_GPS))
    return TileAssignment(lists=lists, counts=counts, rays_t=rays_all,
                          pix_t=pix_all, plan=plan)


def _forward_tiled(F, lists, counts, rays_t, pix_t, static: _StaticArgs):
    """F [N+1, 16], lists [T, K] -> (out [T, P, 8], tbound [T, P, K/C])."""
    return kernels.raster_fwd(F, lists, counts, rays_t, pix_t,
                              chunk=static.chunk, width=static.width,
                              with_median=static.with_median,
                              with_dist=static.with_dist)


def _reduce_rows_with_ranksum(rows_all, plan: RanksumPlan, n_plus1: int):
    """rows_all [R, 16] per-slot gradient rows -> dF [N+1, 16] through the
    id-sorted rank plan: K3 sums into a dense rank accumulator, then each
    id reads its rank row (absent ids read the zero dummy row)."""
    r_alloc = binning._ranksum_alloc(n_plus1, RS_GROUP)
    dFc = kernels.ranksum_rows(rows_all, plan.pos, plan.ranks, r_alloc)
    return dFc[plan.rank_of_id.long()]


def _backward_tiled(F, lists, counts, rays_t, pix_t, tbound, outs, g,
                    static: _StaticArgs, plan: RanksumPlan | None):
    """-> dF [N+1, 16]: K2's per-slot rows, reduced by K3 (with a plan)
    or K4."""
    dFg = kernels.raster_bwd(F, lists, counts, rays_t, pix_t, tbound, outs,
                             g, chunk=static.chunk, width=static.width,
                             with_dist=static.with_dist)
    n_plus1 = F.shape[0]
    if plan is not None:
        return _reduce_rows_with_ranksum(dFg.reshape(-1, 16), plan, n_plus1)
    return kernels.scatter_rows(dFg, lists, counts, n_plus1)


class _RasterCore(torch.autograd.Function):
    """out [T, P, 8] = K1(F); its backward is K2 then K3 or K4.  Only F
    receives a gradient."""

    @staticmethod
    def forward(ctx, F, lists, counts, rays_t, pix_t, static, plan):
        out, tbound = _forward_tiled(F, lists, counts, rays_t, pix_t,
                                     static)
        ctx.save_for_backward(F, lists, counts, rays_t, pix_t, tbound, out)
        ctx.static = static
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, g):
        F, lists, counts, rays_t, pix_t, tbound, out = ctx.saved_tensors
        dF = _backward_tiled(F, lists, counts, rays_t, pix_t, tbound, out,
                             g.contiguous(), ctx.static, ctx.plan)
        return dF, None, None, None, None, None, None


def rasterize_cuda(xyz, scaling, rotation, opacity, T_cw, K, params,
                   tiles: TileAssignment | None = None) -> dict:
    """Channel dict matching eager_ref.rasterize_eager, through the tiled
    kernel path (``tiles`` reuses a frozen binning)."""
    _check_params(params)
    height, width = params.height, params.width
    tile_h, tile_w = params.tile_h, params.tile_w
    packed = common.pack_surfels(xyz, scaling, rotation, opacity, T_cw, K)
    if tiles is None:
        tiles = prepare_tiles(xyz, scaling, rotation, opacity, T_cw, K,
                              params)
    F = binning.pack_features(packed)
    static = _StaticArgs(chunk=params.chunk, width=width,
                         with_median=params.with_median,
                         with_dist=params.with_dist)
    out = _RasterCore.apply(F, tiles.lists, tiles.counts, tiles.rays_t,
                            tiles.pix_t, static, tiles.plan)
    chans = binning.untile_px(out, height, width, tile_h, tile_w)
    return {
        "depth_sum": chans[0],
        "alpha": chans[1],
        "normal_sum": torch.movedim(chans[2:5], 0, -1),
        "median": chans[5],
        "dist": chans[6],
        "final_T": chans[7],
        "radii": packed.radius_px,
    }
