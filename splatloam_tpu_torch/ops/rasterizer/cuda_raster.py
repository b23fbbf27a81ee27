"""Rasterizer on the hand-written CUDA kernels (forward + backward).

Counterpart of splatloam_tpu/ops/rasterizer/pallas_raster.py: the tiled,
bucketed and flat slot layouts, one view or B views over one surfel set:

  * binning.py produces depth-ordered per-tile surfel lists (torch ops);
  * the forward kernel (K1) composites each tile's chunks front to back and
    saves every chunk's start transmittance;
  * the backward kernel (K2) replays the live chunks in reverse with O(P)
    suffix carries and writes per-slot feature-gradient rows;
  * the rows reduce to per-surfel gradients by ``params.scatter``:
      "ranksum" - the rank-space segmented sum (K3) over a rebin-time
                  id-sort, and, when the plan is truncated (RS_TRUNC), the
                  overflow scatter (K6) for the spilled real entries;
      "rmw"     - an atomic scatter-add (K4, or K10 with
                  ``scatter_tps`` > 1);
      "plan"    - rebin-time occurrence tables: a gather of each surfel's
                  first 4 rows summed in torch, plus K6 for the rest;
      "fused"   - no rows at all: K5 is K2 adding each slot's row into the
                  pool inside the kernel;
  * ``layout="bucketed"`` (one view) splits the tiles into two capacity
    buckets: K1 per bucket, then K2 per bucket + K3 with a ranksum plan,
    else K5 per bucket;
  * ``layout="flat"`` packs each tile's slots back to back in one
    chunk-aligned pool (binning.build_flat_lists): K7 forward, K8 backward,
    K9 scatter-add; ``scatter`` and ``scatter_tps`` do not apply;
  * B views (``rasterize_cuda_batched``) share each launch: their features
    stack into one pool F [B*(N+1), 16], their slot ids carry each view's
    row offset, and per-view reduction plans reduce view by view;
  * gradients reach the surfel params and the poses through torch autograd
    of ``pack_surfels``, summed over the views;
  * the mapper's loss (``rasterize_loss_cuda_batched``): K11 takes the
    forward's output to each view's image losses and writes their
    cotangent for the backward beside them (``_RasterLoss``), so no
    channel dict is built on that path;
  * every channel is differentiated.  Over the composited slots alpha +
    final T = 1 exactly, so the final-T cotangent is folded into alpha's
    before the backward (``_fold_final_T``) and no kernel reads it; with
    the median (``with_median``) the forward also returns each pixel's
    median slot, and the backward kernels' MED variant adds the median's
    cotangent at exactly that slot.

The kernels gather their features from F by the slot ids themselves, so
the JAX package's separate feature gather (and its [T, 16, K] copy kept
for the backward) has no counterpart here.  On CPU tensors every kernel
wrapper runs its plain PyTorch version (kernels.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import binning, common, kernels

# ranksum plan geometry: entries per group and groups per step (the plan's
# padding unit); fixed so the plan equals the JAX package's
RS_GROUP = 128
RS_GPS = 64
# sorted-truncation fraction of the ranksum plan (0 = keep all T*K slots;
# 0 < f < 1 = keep the first f*T*K id-sorted entries plus an overflow list
# reduced by K6)
RS_TRUNC = 0.0
# occurrence columns of the "plan" reduction, and the unit of its overflow
# cap (the JAX package's overflow chunk)
PLAN_M = 4
OV_CHUNK = 512
SCATTER_MODES = ("rmw", "ranksum", "fused", "plan")
LAYOUTS = ("tiled", "bucketed", "flat")


class RanksumPlan(NamedTuple):
    """Rebin-time id-sort for the rank-space segmented-sum reduction
    (binning.build_ranksum_plan).  The ov_* fields exist only under sorted
    truncation: the main path covers the first E id-sorted entries, the
    real entries spilled past E go through K6."""
    pos: torch.Tensor         # [E] int32 flat slot position, id-sorted
    ranks: torch.Tensor       # [E] int32 dense rank of the entry's id (pad -1)
    w_first: torch.Tensor     # [E/group] int32 first rank of each group
    rank_of_id: torch.Tensor  # [N+1] int32 rank row per id (absent -> dummy)
    ov_slots: torch.Tensor | None = None   # [<= OvCap] int32 slot positions
    ov_ids: torch.Tensor | None = None     # [<= OvCap] int32 ids (pad N)
    n_ov: torch.Tensor | None = None       # [] int32 live overflow entries


class ScatterPlan(NamedTuple):
    """Rebin-time occurrence tables of the gather-sum reduction
    (binning.build_scatter_plan)."""
    occ: torch.Tensor       # [N+1, M] int32 flat slot ids (pad T*K)
    ov_slots: torch.Tensor  # [OvCap] int32 (pad T*K)
    ov_ids: torch.Tensor    # [OvCap] int32 (pad N)
    n_ov: torch.Tensor      # [] int32


class TileAssignment(NamedTuple):
    """Frozen binning state, reusable across optimization iterations (the
    mapper rebins every ``compute.rebin_every`` steps with a pixel margin
    on the binning radius to absorb parameter drift).  From
    prepare_tiles_batched every field, the plan's included, has a leading
    [B] axis."""
    lists: torch.Tensor    # [T, K] int32
    counts: torch.Tensor   # [T] int32
    rays_t: torch.Tensor   # [T, P, 3]
    pix_t: torch.Tensor    # [T, P, 2]
    # None -> the scatter-add (K4) or fused (K5) reduction
    plan: RanksumPlan | ScatterPlan | None = None


class FlatTiles(NamedTuple):
    """Frozen binning state for ``layout="flat"`` (compacted slot pool,
    binning.build_flat_lists); a leading [B] axis on every field from
    prepare_tiles_batched."""
    flat_ids: torch.Tensor       # [E] int32 (pad N)
    tile_of_chunk: torch.Tensor  # [E/chunk] int32
    counts: torch.Tensor         # [T] int32 real per-tile counts
    rays_t: torch.Tensor         # [T, P, 3]
    pix_t: torch.Tensor          # [T, P, 2]
    starts: torch.Tensor         # [T+1] int32 chunk-aligned segment starts


class BucketedTiles(NamedTuple):
    """Frozen binning state for ``layout="bucketed"``: the q_big
    highest-count tiles keep the full slot capacity, the rest truncate to
    k_small (binning.build_bucketed_lists); rays/pix are gathered per
    bucket at rebin time."""
    lists_b: torch.Tensor   # [Qb, Kb] int32
    counts_b: torch.Tensor  # [Qb]
    idx_b: torch.Tensor     # [Qb] tile indices (ascending)
    rays_b: torch.Tensor    # [Qb, P, 3]
    pix_b: torch.Tensor     # [Qb, P, 2]
    lists_s: torch.Tensor   # [Qs, Ks]
    counts_s: torch.Tensor  # [Qs]
    idx_s: torch.Tensor     # [Qs]
    rays_s: torch.Tensor    # [Qs, P, 3]
    pix_s: torch.Tensor     # [Qs, P, 2]
    plan: RanksumPlan | None = None   # over the concatenated bucket slots


class _StaticArgs(NamedTuple):
    chunk: int
    width: int
    with_median: bool
    with_dist: bool
    fused: bool
    scatter_tps: int = 1
    n_views: int = 1


def _static(params, n_views: int = 1) -> _StaticArgs:
    return _StaticArgs(chunk=params.chunk, width=params.width,
                       with_median=params.with_median,
                       with_dist=params.with_dist,
                       fused=params.scatter == "fused",
                       scatter_tps=params.scatter_tps, n_views=n_views)


def _check_params(params) -> None:
    if params.height % params.tile_h or params.width % params.tile_w:
        raise ValueError(f"image {params.height}x{params.width} not "
                         f"divisible by tile {params.tile_h}x{params.tile_w}")
    if params.tile_list_capacity % params.chunk:
        raise ValueError("tile_list_capacity must be a chunk multiple")
    if params.scatter not in SCATTER_MODES:
        raise ValueError(f"unknown scatter mode {params.scatter!r}; the "
                         f"port has {SCATTER_MODES}")
    if params.layout not in LAYOUTS:
        raise ValueError(f"unknown layout {params.layout!r}; the port has "
                         f"{LAYOUTS}")
    if params.layout == "bucketed" and params.bucket_k_small % params.chunk:
        raise ValueError("bucket_k_small must be a chunk multiple")


def _bucketed_tiles(packed, rays_all, pix_all, n_surfels: int, params):
    height, width = params.height, params.width
    n_tiles = (height // params.tile_h) * (width // params.tile_w)
    q_big = min(n_tiles - 1, max(1, int(n_tiles * params.bucket_frac)))
    k_small = params.bucket_k_small or params.chunk
    lb, cb, ib, ls, cs, is_ = binning.build_bucketed_lists(
        packed, height, width, params.tile_h, params.tile_w,
        params.tile_list_capacity, k_small, q_big, params.cap_ty,
        params.cap_tx)
    plan = None
    if params.scatter == "ranksum":
        flat = torch.cat([lb.reshape(-1), ls.reshape(-1)])
        plan = RanksumPlan(*binning.build_ranksum_plan(
            flat, n_surfels, group=RS_GROUP, gps=RS_GPS,
            trunc_frac=RS_TRUNC))
    ib_l, is_l = ib.long(), is_.long()
    return BucketedTiles(lists_b=lb, counts_b=cb, idx_b=ib,
                         rays_b=rays_all[ib_l], pix_b=pix_all[ib_l],
                         lists_s=ls, counts_s=cs, idx_s=is_,
                         rays_s=rays_all[is_l], pix_s=pix_all[is_l],
                         plan=plan)


def _flat_capacity_for(params) -> int:
    """Flat slot budget: ``flat_capacity`` when set, else half the [T, K]
    slot count, rounded down to a chunk multiple (at least one chunk)."""
    n_tiles = (params.height // params.tile_h) * \
        (params.width // params.tile_w)
    cap = (params.flat_capacity if params.flat_capacity > 0
           else n_tiles * params.tile_list_capacity // 2)
    return max(params.chunk, cap // params.chunk * params.chunk)


def scatter_plan(lists, n_surfels: int) -> ScatterPlan:
    """The occurrence plan of ``scatter="plan"`` over tile lists [T, K],
    with the JAX package's overflow cap of a sixth of the slots.  The
    padding id's row of ``occ`` (its first PLAN_M slots, past some tile's
    count) is pointed at the pad slot T*K: K2 leaves those rows
    unwritten, and F's pad row is a constant, so its gradient row is 0
    as under the other reductions."""
    ov_cap = max(OV_CHUNK, lists.numel() // 6 // OV_CHUNK * OV_CHUNK)
    occ, *rest = binning.build_scatter_plan(lists, n_surfels, m=PLAN_M,
                                            ov_cap=ov_cap)
    occ[n_surfels] = lists.numel()
    return ScatterPlan(occ, *rest)


def prepare_tiles(xyz, scaling, rotation, opacity, T_cw, K, params,
                  margin_px: float = 0.0):
    """Binning only (no gradients): depth sort + tile lists + rays, plus
    the reduction's plan (``scatter`` "ranksum" or "plan").  Returns a
    TileAssignment, BucketedTiles under ``layout="bucketed"`` or FlatTiles
    under ``layout="flat"``."""
    _check_params(params)
    height, width = params.height, params.width
    tile_h, tile_w = params.tile_h, params.tile_w
    n_surfels = xyz.shape[0]
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
        if params.layout == "bucketed":
            return _bucketed_tiles(packed, rays_all, pix_all, n_surfels,
                                   params)
        if params.layout == "flat":
            flat_ids, toc, starts, counts = binning.build_flat_lists(
                packed, height, width, tile_h, tile_w,
                params.tile_list_capacity, params.chunk,
                _flat_capacity_for(params), params.cap_ty, params.cap_tx)
            return FlatTiles(flat_ids=flat_ids, tile_of_chunk=toc,
                             counts=counts, rays_t=rays_all, pix_t=pix_all,
                             starts=starts)
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
        if params.scatter == "plan":
            plan = scatter_plan(lists, n_surfels)
        elif params.scatter == "ranksum":
            plan = RanksumPlan(*binning.build_ranksum_plan(
                lists, n_surfels, group=RS_GROUP, gps=RS_GPS,
                trunc_frac=RS_TRUNC))
    return TileAssignment(lists=lists, counts=counts, rays_t=rays_all,
                          pix_t=pix_all, plan=plan)


def prepare_tiles_batched(xyz, scaling, rotation, opacity, T_cw, K, params,
                          margin_px: float = 0.0):
    """Per-view binning (poses T_cw [B, 4, 4], intrinsics K [B, 3, 3],
    one surfel set), stacked on a leading [B] axis."""
    if params.layout == "bucketed":
        raise ValueError("layout='bucketed' is single-view (use "
                         "prepare_tiles)")
    return _stack_views([
        prepare_tiles(xyz, scaling, rotation, opacity, T_cw[v], K[v],
                      params, margin_px=margin_px)
        for v in range(T_cw.shape[0])])


def _stack_views(views):
    """Per-view binning states (or plans) -> one with a leading [B] axis
    on every tensor (one view: a view of its tensors, no copy)."""
    return type(views[0])(*(
        None if f[0] is None else
        _stack_views(f) if isinstance(f[0], tuple) else
        torch.stack(f) if len(f) > 1 else f[0][None]
        for f in zip(*views)))


def _view(state, v: int):
    """View ``v`` of a state with a leading [B] axis."""
    return type(state)(*(None if x is None else x[v] for x in state))


def _pool_ids(ids, n_plus1: int):
    """Per-view slot ids [B, ...] -> ids into the pool F [B*(N+1), 16]."""
    b = ids.shape[0]
    if b == 1:
        return ids
    offs = torch.arange(b, dtype=torch.int32, device=ids.device) * n_plus1
    return ids + offs.reshape(b, *([1] * (ids.dim() - 1)))


def _forward_tiled(F, lists, counts, rays_t, pix_t, static: _StaticArgs):
    """F [R, 16], lists [T, K] -> (out [T, P, 8], tbound [T, P, K/C],
    med_slot [T, P] or None without the median)."""
    out, tbound, *slot = kernels.raster_fwd(
        F, lists, counts, rays_t, pix_t, chunk=static.chunk,
        width=static.width, with_median=static.with_median,
        with_dist=static.with_dist, return_slot=static.with_median)
    return out, tbound, (slot[0] if slot else None)


def _fold_final_T(g):
    """Output cotangents [..., 8] with final T's folded into alpha's
    (alpha + final T = 1 over the composited slots), so the backward reads
    channels 0-6 only."""
    g = g.clone(memory_format=torch.contiguous_format)
    g[..., 1] -= g[..., 7]
    return g


def _reduce_rows_with_ranksum(rows_all, plan: RanksumPlan, n_plus1: int):
    """rows_all [R, 16] per-slot gradient rows -> dF [N+1, 16] through the
    id-sorted rank plan: K3 sums into a dense rank accumulator, then each
    id reads its rank row (absent ids read the zero dummy row); a
    truncated plan adds its spilled real entries through K6.  Row N, the
    padding id's, comes out 0: F's pad row is a constant, so nothing
    reads its gradient, and K3 skips its entries."""
    r_alloc = binning._ranksum_alloc(n_plus1, RS_GROUP)
    dFc = kernels.ranksum_rows(rows_all, plan.pos, plan.ranks,
                               plan.rank_of_id[n_plus1 - 1:], r_alloc)
    dF = dFc[plan.rank_of_id.long()]
    if plan.ov_slots is None:
        return dF
    return dF + kernels.scatter_overflow(rows_all, plan.ov_slots, plan.ov_ids,
                                         plan.n_ov, n_plus1)


def _scatter_with_plan(rows_all, plan: ScatterPlan, n_plus1: int):
    """rows_all [T*K, 16] -> dF [N+1, 16] through the occurrence tables:
    one [N+1, M]-row gather summed over M (pad slot T*K reads an appended
    zero row), plus K6 over the occurrences beyond M."""
    m = plan.occ.shape[1]
    rows1 = torch.cat([rows_all, rows_all.new_zeros((1, 16))])
    dF = rows1[plan.occ.reshape(-1).long()].reshape(n_plus1, m, 16).sum(1)
    return dF + kernels.scatter_overflow(rows1, plan.ov_slots, plan.ov_ids,
                                         plan.n_ov, n_plus1)


def _backward_tiled(F, lists, counts, rays_t, pix_t, tbound, outs, g,
                    static: _StaticArgs, plans, med_slot=None):
    """-> dF [B*(N+1), 16] over the pool of ``static.n_views`` views: K5
    under ``fused``; else K2's per-slot rows, reduced view by view by its
    plan (``plans``, one per view: K3 (+ K6) or gather-sum + K6), or over
    the pool by K4, or by K10 when ``scatter_tps`` > 1 (reduced to a
    divisor of the tile count, as the JAX package does)."""
    n_rows = F.shape[0]
    kw = dict(chunk=static.chunk, width=static.width,
              with_dist=static.with_dist, med_slot=med_slot)
    if static.fused:
        return kernels.raster_bwd_fused(F, lists, counts, rays_t, pix_t,
                                        tbound, outs, g, n_rows, **kw)
    dFg = kernels.raster_bwd(F, lists, counts, rays_t, pix_t, tbound, outs,
                             g, **kw)
    if plans is not None:
        b = static.n_views
        reduce = (_reduce_rows_with_ranksum
                  if isinstance(plans[0], RanksumPlan) else _scatter_with_plan)
        rows = dFg.reshape(b, -1, 16)
        return torch.cat([reduce(rows[v], plans[v], n_rows // b)
                          for v in range(b)])
    tps = max(1, static.scatter_tps)
    while lists.shape[0] % tps:
        tps //= 2
    return kernels.scatter_rows_tps(dFg, lists, counts, n_rows, tps)


class _RasterCore(torch.autograd.Function):
    """out [B*T, P, 8] = K1(F) over the pool F [B*(N+1), 16] and the
    views' offset lists [B*T, K]; its backward is K5, or K2 then the
    per-view plans' reduction or K4/K10.  Only F receives a gradient."""

    @staticmethod
    def forward(ctx, F, lists, counts, rays_t, pix_t, static, plans):
        out, tbound, med_slot = _forward_tiled(F, lists, counts, rays_t,
                                               pix_t, static)
        ctx.save_for_backward(F, lists, counts, rays_t, pix_t, tbound, out,
                              med_slot)
        ctx.static = static
        ctx.plans = plans
        return out

    @staticmethod
    def backward(ctx, g):
        return (_RasterCore.grad(ctx, _fold_final_T(g)),
                None, None, None, None, None, None)

    @staticmethod
    def grad(ctx, g):
        """dF from the output cotangents ``g``, final T's folded in."""
        (F, lists, counts, rays_t, pix_t, tbound, out,
         med_slot) = ctx.saved_tensors
        return _backward_tiled(F, lists, counts, rays_t, pix_t, tbound, out,
                               g, ctx.static, ctx.plans, med_slot)


class _RasterCoreFlat(torch.autograd.Function):
    """out [B*T, P, 8] = K7(F) over the pool F [B*(N+1), 16], the views'
    offset flat slot ids [B*E] and segment starts [B, T+1]; its backward
    is K8's per-slot rows summed into the pool by K9 (the owned slots'
    rows but the pads')."""

    @staticmethod
    def forward(ctx, F, ids, starts, rays_t, pix_t, static):
        out, tbound, *slot = kernels.raster_fwd_flat(
            F, ids, starts, rays_t, pix_t, chunk=static.chunk,
            width=static.width, with_median=static.with_median,
            with_dist=static.with_dist, return_slot=static.with_median)
        ctx.save_for_backward(F, ids, starts, rays_t, pix_t, tbound, out,
                              slot[0] if slot else None)
        ctx.static = static
        return out

    @staticmethod
    def backward(ctx, g):
        (F, ids, starts, rays_t, pix_t, tbound, out,
         med_slot) = ctx.saved_tensors
        static = ctx.static
        rows = kernels.raster_bwd_flat(
            F, ids, starts, rays_t, pix_t, tbound, out, _fold_final_T(g),
            chunk=static.chunk, width=static.width,
            with_dist=static.with_dist, med_slot=med_slot)
        dF = kernels.scatter_rows_flat(rows, ids, starts, F.shape[0])
        return dF, None, None, None, None, None


class _RasterLoss(torch.autograd.Function):
    """loss [B] = image_loss(out) of K1's output out [B*T, P, 8] over the
    tiled layout (``_RasterCore``'s forward), ``image_loss`` K11 against
    the views' keyframes, which writes the cotangent g of the loss with
    respect to out beside it; the backward scales each view's g by the
    loss's cotangent and runs ``_RasterCore``'s backward on it.  Only F
    receives a gradient."""

    @staticmethod
    def forward(ctx, image_loss, F, *layout):
        out = _RasterCore.forward(ctx, F, *layout)
        loss, ctx.g = image_loss(out)
        ctx.n_layout = len(layout)
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        g = ctx.g
        g = (g.reshape(g_loss.shape[0], -1) * g_loss[:, None]).reshape(
            g.shape)
        return (None, _RasterCore.grad(ctx, g), *(None,) * ctx.n_layout)


class _RasterCoreBucketed(torch.autograd.Function):
    """out [T, P, 8]: K1 per bucket, scattered back into tile order.  Its
    backward is K2 per bucket then K3 (+ K6) over the concatenated rows
    with a ranksum plan, else K5 per bucket with the two pools summed."""

    @staticmethod
    def forward(ctx, F, bt: BucketedTiles, static):
        out_b, tb_b, ms_b = _forward_tiled(F, bt.lists_b, bt.counts_b,
                                           bt.rays_b, bt.pix_b, static)
        out_s, tb_s, ms_s = _forward_tiled(F, bt.lists_s, bt.counts_s,
                                           bt.rays_s, bt.pix_s, static)
        n_tiles = bt.lists_b.shape[0] + bt.lists_s.shape[0]
        out = out_b.new_zeros((n_tiles, *out_b.shape[1:]))
        out[bt.idx_b.long()] = out_b
        out[bt.idx_s.long()] = out_s
        ctx.save_for_backward(F, tb_b, out_b, tb_s, out_s, ms_b, ms_s)
        ctx.bt = bt
        ctx.static = static
        return out

    @staticmethod
    def backward(ctx, g):
        F, tb_b, out_b, tb_s, out_s, ms_b, ms_s = ctx.saved_tensors
        bt, static = ctx.bt, ctx.static
        n_plus1 = F.shape[0]
        kw = dict(chunk=static.chunk, width=static.width,
                  with_dist=static.with_dist)
        g = _fold_final_T(g)
        # each bucket's median slots index its own lists
        buckets = [
            ((bt.lists_b, bt.counts_b, bt.rays_b, bt.pix_b, tb_b, out_b,
              g[bt.idx_b.long()].contiguous()), ms_b),
            ((bt.lists_s, bt.counts_s, bt.rays_s, bt.pix_s, tb_s, out_s,
              g[bt.idx_s.long()].contiguous()), ms_s)]
        if bt.plan is not None:
            rows = torch.cat([
                kernels.raster_bwd(F, *b, med_slot=ms, **kw).reshape(-1, 16)
                for b, ms in buckets])
            dF = _reduce_rows_with_ranksum(rows, bt.plan, n_plus1)
        else:
            dF_b, dF_s = (kernels.raster_bwd_fused(F, *b, n_plus1,
                                                   med_slot=ms, **kw)
                          for b, ms in buckets)
            dF = dF_b + dF_s
        return dF, None, None


def _channels(out, radii, params) -> dict:
    """Kernel output [B, T, P, 8] -> the channel dict with a leading [B]."""
    return {**kernels.out_channels(out, params.height, params.width,
                                   params.tile_h, params.tile_w),
            "radii": radii}


def rasterize_cuda(xyz, scaling, rotation, opacity, T_cw, K, params,
                   tiles: TileAssignment | FlatTiles | BucketedTiles
                   | None = None) -> dict:
    """Channel dict matching eager_ref.rasterize_eager, through the kernel
    path (``tiles`` reuses a frozen binning): the one-view case of
    rasterize_cuda_batched, or the bucketed layout."""
    _check_params(params)
    if tiles is None:
        tiles = prepare_tiles(xyz, scaling, rotation, opacity, T_cw, K,
                              params)
    if not isinstance(tiles, BucketedTiles):
        chans = rasterize_cuda_batched(xyz, scaling, rotation, opacity,
                                       T_cw[None], K[None], params,
                                       tiles=_stack_views([tiles]))
        return {k: v[0] for k, v in chans.items()}
    packed = common.pack_surfels(xyz, scaling, rotation, opacity, T_cw, K)
    F = binning.pack_features(packed)
    out = _RasterCoreBucketed.apply(F, tiles, _static(params))
    return {k: v[0] for k, v in
            _channels(out[None], packed.radius_px[None], params).items()}


def _batched_core(xyz, scaling, rotation, opacity, T_cw, K, params, tiles):
    """The B views' pool and frozen binning as a core's inputs ->
    (the packed views, the core Function, its arguments (F first))."""
    _check_params(params)
    if params.layout == "bucketed":
        raise ValueError("layout='bucketed' is single-view (use "
                         "rasterize_cuda)")
    b = T_cw.shape[0]
    packed = [common.pack_surfels(xyz, scaling, rotation, opacity, T_cw[v],
                                  K[v]) for v in range(b)]
    if tiles is None:
        tiles = prepare_tiles_batched(xyz, scaling, rotation, opacity, T_cw,
                                      K, params)
    feats = [binning.pack_features(p) for p in packed]
    F = feats[0] if b == 1 else torch.cat(feats)
    n_plus1 = F.shape[0] // b
    static = _static(params, b)
    rays = tiles.rays_t.reshape(-1, *tiles.rays_t.shape[2:])
    pix = tiles.pix_t.reshape(-1, *tiles.pix_t.shape[2:])
    if isinstance(tiles, FlatTiles):
        return packed, _RasterCoreFlat, (
            F, _pool_ids(tiles.flat_ids, n_plus1).reshape(-1), tiles.starts,
            rays, pix, static)
    plans = (None if tiles.plan is None else
             tuple(_view(tiles.plan, v) for v in range(b)))
    lists = _pool_ids(tiles.lists, n_plus1)
    return packed, _RasterCore, (
        F, lists.reshape(-1, lists.shape[-1]), tiles.counts.reshape(-1),
        rays, pix, static, plans)


def rasterize_cuda_batched(xyz, scaling, rotation, opacity, T_cw, K, params,
                           tiles: TileAssignment | FlatTiles | None = None
                           ) -> dict:
    """Multi-view rasterization: poses T_cw [B, 4, 4] and intrinsics
    K [B, 3, 3] over one surfel set, all views in one launch of each
    kernel.  Every channel gains a leading [B] axis; ``tiles`` (from
    prepare_tiles_batched) reuses a frozen binning."""
    packed, core, args = _batched_core(xyz, scaling, rotation, opacity,
                                       T_cw, K, params, tiles)
    b = T_cw.shape[0]
    out = core.apply(*args)
    radii = (packed[0].radius_px[None] if b == 1 else
             torch.stack([p.radius_px for p in packed]))
    return _channels(out.reshape(b, -1, *out.shape[1:]), radii, params)


def rasterize_loss_cuda_batched(xyz, scaling, rotation, opacity, T_cw, K,
                                gt_depth, valid, params, *,
                                lambda_normal: float, lambda_alpha: float,
                                depth_ratio: float,
                                tiles: TileAssignment | FlatTiles
                                | None = None):
    """The mapper's image losses of B views (api.image_losses of each
    decoded render), loss [B]: the views' forward, as in
    rasterize_cuda_batched, then K11 on its output, against the
    keyframes' depth and valid mask [B, H, W].  The tiled layout only
    (the mapper's)."""
    if params.layout != "tiled":
        raise ValueError(f"the image losses take the tiled layout, not "
                         f"layout={params.layout!r}")
    *_, args = _batched_core(xyz, scaling, rotation, opacity, T_cw, K,
                             params, tiles)

    def image_loss(out):
        return kernels.image_loss(
            out, gt_depth, valid, K, T_cw, tile_h=params.tile_h,
            tile_w=params.tile_w, lambda_normal=lambda_normal,
            lambda_alpha=lambda_alpha, depth_ratio=depth_ratio)
    return _RasterLoss.apply(image_loss, *args)
