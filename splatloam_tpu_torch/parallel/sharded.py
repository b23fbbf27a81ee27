"""Sharded mapping: data parallelism over the range image x FSDP over
surfels, one process per rank.

Counterpart of splatloam_tpu/parallel/sharded.py.  Where the JAX package
expresses each program with shard_map over a ("data", "model") mesh, here
every rank runs the same Python program on its own slice of the state and
meets the others in the collectives of collectives.py:

  * the surfel pool and its Adam moments live split over "model" (rank m
    holds rows [m*C/n, (m+1)*C/n)); a step all-gathers the parameters,
    computes the gradient of the full pool, and each rank keeps and
    updates its own rows (every "model" rank of a data row computed the
    same full gradient, so a slice replaces the reduce-scatter);
  * each "data" rank renders its block of image rows ("rows"), or a
    count-balanced subset of tiles ("tiles", "ring"); the loss terms are
    sums over the rank's pixels with globally computed normalisers, and
    the gradients (and the loss, in the same buffer) are summed over
    "data";
  * "ring" splits the pool over "model" by camera depth instead: each rank
    bins and renders only its depth band and the bands' segment states
    fold front to back (ring.py); the band's gradient stays on its rank.

Every rank holds the whole keyframe stack (each process read the same
frames), so a rank slices its rows or tiles locally where the JAX
programs receive them sharded; the valid-pixel normaliser, which JAX
psums over "data", is the count over the whole image every rank already
holds.  The row shard is expressed by shifting the intrinsics' cy, so the
single-device renderer runs unchanged on a row block.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..geometry import se3, spherical
from ..model import surfels as S
from ..model.camera import Camera
from ..ops.rasterizer import binning as BN
from ..ops.rasterizer import common as CM
from ..ops.rasterizer import cuda_raster as CR
from ..ops.rasterizer.api import (RenderParams, _resolve_backend,
                                  prepare_tiles, render)
from . import collectives as C
from .ring import ring_fold, ring_reshard


# ---------------------------------------------------------------------------
# state layout
# ---------------------------------------------------------------------------

def _model_rows(mesh, capacity: int) -> tuple[int, int]:
    if capacity % mesh.model:
        raise ValueError(f"pool capacity {capacity} is not a multiple of "
                         f"parallel.model={mesh.model}")
    rows = capacity // mesh.model
    return mesh.model_index * rows, rows


def _slice_model(tree, mesh):
    """The local "model" rows of full-size leaves (a tensor, or a tuple of
    them)."""
    if torch.is_tensor(tree):
        r0, rows = _model_rows(mesh, tree.shape[0])
        return tree[r0:r0 + rows].clone()
    return type(tree)(*(_slice_model(a, mesh) for a in tree))


def shard_model_state(mesh, surfels: S.Surfels, adam: S.AdamState):
    """This rank's "model" slice of the pool and of its Adam state."""
    return (S.Surfels(params=_slice_model(surfels.params, mesh),
                      active=_slice_model(surfels.active, mesh)),
            S.AdamState(mu=_slice_model(adam.mu, mesh),
                        nu=_slice_model(adam.nu, mesh), step=adam.step))


def _gather_params(p: S.SurfelParams, mesh,
                   compact: bool = False) -> S.SurfelParams:
    """All-gather the parameter leaves over "model" (FSDP materialise),
    as one [rows, 10] float32 block.

    ``compact``: gather the non-position leaves in float16 (master shards,
    gradients and all compute stay float32).  The parameter gather is the
    largest per-iteration collective, and quat/log_scale/logit_opacity
    live in ranges where float16's 1e-3 absolute error is far below the
    optimisation's noise; xyz stays float32 (at 50 m range a
    half-precision position quantum is about 2.4 cm, the order of the
    depth loss itself).  Row bytes 40 -> 26."""
    g = mesh.group("model")
    rest = torch.cat([p.log_scale, p.quat, p.logit_opacity[:, None]], 1)
    if compact:
        xyz = C.all_gather_raw(p.xyz, g)
        rest = C.all_gather_raw(rest.to(torch.float16), g).to(torch.float32)
    else:
        both = C.all_gather_raw(torch.cat([p.xyz, rest], 1), g)
        xyz, rest = both[:, :3], both[:, 3:]
    return S.SurfelParams(xyz=xyz.contiguous(),
                          log_scale=rest[:, 0:2].contiguous(),
                          quat=rest[:, 2:6].contiguous(),
                          logit_opacity=rest[:, 6].contiguous())


def _gather_active(active: torch.Tensor, mesh) -> torch.Tensor:
    return C.all_gather_raw(active.to(torch.uint8),
                            mesh.group("model")).bool()


def gather_model_state(mesh, surf: S.Surfels, adam: S.AdamState):
    """The whole pool and Adam state from the ranks' "model" slices."""
    return (S.Surfels(params=_gather_params(surf.params, mesh),
                      active=_gather_active(surf.active, mesh)),
            S.AdamState(mu=_gather_params(adam.mu, mesh),
                        nu=_gather_params(adam.nu, mesh), step=adam.step))


def _sum_over_data(grads: S.SurfelParams, loss: torch.Tensor, mesh):
    """psum of the gradient leaves and the loss over "data", in one
    buffer (the loss rides with the gradients, as XLA fuses it)."""
    n = grads.xyz.shape[0]
    buf = torch.cat([torch.cat([g.reshape(n, -1) for g in grads], 1)
                     .reshape(-1), loss.detach().reshape(1)])
    C.all_reduce_(buf, mesh.group("data"))
    flat = buf[:-1].reshape(n, 10)
    return (S.SurfelParams(xyz=flat[:, 0:3], log_scale=flat[:, 3:5],
                           quat=flat[:, 5:9], logit_opacity=flat[:, 9]),
            buf[-1])


# ---------------------------------------------------------------------------
# losses (Eq 15-17 as sums over a rank's pixels)
# ---------------------------------------------------------------------------

def _decode(depth_sum, alpha, normal_sum, median, R_wc, depth_ratio):
    mask = alpha > 0.0
    safe = torch.where(mask, alpha, 1.0)
    surf_depth = torch.where(mask, depth_sum / safe, 0.0)
    if depth_ratio:
        surf_depth = surf_depth * (1.0 - depth_ratio) + median * depth_ratio
    normal_cam = normal_sum / safe[..., None]
    rend_normal = torch.where(mask[..., None], normal_cam @ R_wc.T, 0.0)
    return surf_depth, rend_normal


def _channel_sums(surf_depth, alpha, rend_normal, surf_normal, gt, validf,
                  mc, n_pixels: int, v_sum):
    l1_sum = torch.sum(torch.abs(validf * (surf_depth - gt)))
    ndot = torch.sum(rend_normal * surf_normal, dim=-1)
    n_sum = torch.sum((1.0 - ndot) * validf)
    a = torch.clamp(alpha, 1e-7, 1.0 - 1e-7)
    a_sum = torch.sum(-torch.log(a) * validf)
    return (l1_sum / n_pixels + mc.opt_lambda_alpha * a_sum / v_sum
            + mc.opt_lambda_normal * n_sum / v_sum)


def _scale_penalty(scaling, active, mc, n_data: int):
    """Eq 17, pre-divided by the "data" replication count so the psum of
    the gradients over "data" counts it once."""
    from ..slam.mapper import scale_penalty
    return scale_penalty(scaling, active, mc) / n_data


def _row_shard_camera(K: torch.Tensor, height: int, mesh):
    """Intrinsics of this rank's block of height/n_data rows."""
    h_local = height // mesh.data
    K_local = K.clone()
    K_local[1, 2] -= float(mesh.data_index * h_local)
    return K_local, h_local


def _halo_surf_normal(surf_depth, K_local, T_cw, height: int, h_local: int,
                      mesh):
    """surf_normal on a row shard with a 1-row halo over "data": every
    rank all-gathers each rank's first and last depth rows (JAX's two
    ppermutes; the backward reduce-scatters the halo's cotangent).  Rows
    at the global image border are zeroed as on one device."""
    g = mesh.group("data")
    d, n = g.rank, g.size
    edges = C.all_gather(torch.stack([surf_depth[0], surf_depth[-1]]), g)
    edges = edges.reshape(n, 2, -1)
    zero = torch.zeros_like(surf_depth[:1])
    up = edges[d - 1, 1][None] if d > 0 else zero
    down = edges[d + 1, 0][None] if d < n - 1 else zero
    ext = torch.cat([up, surf_depth, down], dim=0)
    K_ext = K_local.clone()
    K_ext[1, 2] += 1.0               # ext row 0 = local row -1
    normals = spherical.depth_to_normal(ext, K_ext, se3.invert_T(T_cw))[1:-1]
    grow = d * h_local + torch.arange(h_local, device=surf_depth.device)
    border = (grow == 0) | (grow == height - 1)
    return torch.where(border[:, None, None], 0.0, normals)


def _row_tiles(p: S.SurfelParams, active, T_cw, K, params: RenderParams,
               mesh, margin_px: float = 0.0):
    """The kernel path's row block: the block's tiles of a WHOLE-image
    binning.  Binning the block alone (the intrinsics' cy shifted) would
    drop the surfels whose center lies in another block: the binner's
    tile windows reach only as far as the block's own tile rows
    (binning._emit_sorted_keys), so a block of one tile row loses every
    splat centered above or below it."""
    height, width = params.height, params.width
    h_local = height // mesh.data
    if h_local % params.tile_h:
        raise ValueError(f"row block of {h_local} rows is not a multiple "
                         f"of tile_h={params.tile_h}")
    tiles = prepare_tiles(p.xyz, torch.exp(p.log_scale), p.quat,
                          torch.sigmoid(p.logit_opacity) * active, T_cw, K,
                          params, margin_px=margin_px)
    per_block = (h_local // params.tile_h) * (width // params.tile_w)
    mine = torch.arange(mesh.data_index * per_block,
                        (mesh.data_index + 1) * per_block,
                        device=tiles.lists.device)
    return _subset(tiles, mine, p.xyz.shape[0], params.scatter)


def _render_rows(p: S.SurfelParams, active, T_cw, K, mesh,
                 params: RenderParams, depth_ratio: float, tiles=None):
    """This rank's row block -> (surf_depth, rend_alpha, rend_normal,
    K_local, h_local): on eager the single-device renderer with cy
    shifted, on the kernel path the block's tiles (``tiles`` from
    _row_tiles, binned here when None)."""
    height, width = params.height, params.width
    K_local, h_local = _row_shard_camera(K, height, mesh)
    if _resolve_backend(params.backend) == "eager":
        pkg = render(p.xyz, torch.exp(p.log_scale), p.quat,
                     torch.sigmoid(p.logit_opacity) * active, T_cw, K_local,
                     params._replace(height=h_local), depth_ratio)
        return (pkg["surf_depth"], pkg["rend_alpha"], pkg["rend_normal"],
                K_local, h_local)
    if tiles is None:
        tiles = _row_tiles(p, active, T_cw, K, params, mesh)
    out, _ = _raster_tiles(p, active, T_cw, K, tiles, CR._static(params))
    chans = BN.untile_px(out, h_local, width, params.tile_h, params.tile_w)
    surf_depth, rend_normal = _decode(
        chans[0], chans[1], torch.movedim(chans[2:5], 0, -1), chans[5],
        T_cw[:3, :3].T, depth_ratio)
    return surf_depth, chans[1], rend_normal, K_local, h_local


def _rows_loss(p: S.SurfelParams, active, T_cw, K, depth, valid, mesh,
               params: RenderParams, mc, depth_ratio: float, tiles=None):
    """This rank's share of the mapping loss on its row block (depth and
    valid are the whole image)."""
    height, width = params.height, params.width
    surf_depth, alpha, rend_normal, K_local, h_local = _render_rows(
        p, active, T_cw, K, mesh, params, depth_ratio, tiles)
    r0 = mesh.data_index * h_local
    validf = valid.to(torch.float32)
    v_sum = torch.clamp(torch.sum(validf), min=1.0)
    validf = validf[r0:r0 + h_local]
    surf_normal = _halo_surf_normal(surf_depth, K_local, T_cw, height,
                                    h_local, mesh) * alpha[..., None]
    chan = _channel_sums(surf_depth, alpha, rend_normal, surf_normal,
                         depth[r0:r0 + h_local], validf, mc,
                         height * width, v_sum)
    return chan + _scale_penalty(torch.exp(p.log_scale), active, mc,
                                 mesh.data)


def _fsdp_grads(surf: S.Surfels, mesh, compact: bool, loss_fn):
    """Gather the pool, differentiate this rank's loss w.r.t. the whole
    pool, sum over "data" -> (loss, the whole pool's gradient)."""
    full = _gather_params(surf.params, mesh, compact)
    active = _gather_active(surf.active, mesh)
    p = S.SurfelParams(*(a.detach().requires_grad_(True) for a in full))
    loss_local = loss_fn(p, active)
    grads = S.SurfelParams(*torch.autograd.grad(loss_local, p))
    grads, loss = _sum_over_data(grads, loss_local, mesh)
    return loss, grads


def sharded_train_step(mesh, params: RenderParams, hyper: S.AdamHyper,
                       lambda_alpha: float, lambda_normal: float,
                       scaling_max: float, scaling_max_penalty: float,
                       depth_ratio: float = 0.0):
    """One mapper iteration over the mesh: fn(surf_shard, adam_shard, K,
    T_cw, depth, valid) -> (surf_shard, adam_shard, loss), row-DP over
    "data" x FSDP over "model"; depth and valid are whole images."""
    if params.height % mesh.data:
        raise ValueError(f"height {params.height} not divisible by "
                         f"parallel.data={mesh.data}")
    # the loss weights in MappingConfig's names
    mc = SimpleNamespace(opt_lambda_alpha=lambda_alpha,
                         opt_lambda_normal=lambda_normal,
                         opt_scaling_max=scaling_max,
                         opt_scaling_max_penalty=scaling_max_penalty)

    def step(surf_shard, adam_shard, K, T_cw, depth, valid):
        loss, grads = _fsdp_grads(
            surf_shard, mesh, False,
            lambda p, active: _rows_loss(p, active, T_cw, K, depth, valid,
                                         mesh, params, mc, depth_ratio))
        surf2, adam2 = S.adam_step(surf_shard, adam_shard,
                                   _slice_model(grads, mesh), hyper)
        return surf2, adam2, loss

    return step


# ---------------------------------------------------------------------------
# the mapper's programs: optimize loop, densify, prune on sharded state
# ---------------------------------------------------------------------------

def _maybe_plan(sub_lists, n_surfels: int, scatter: str):
    """Gradient-reduction plan for a rank's tile subset, per
    ``compute.scatter``: "ranksum" (id-sort + segmented sum), "plan"
    (occurrence tables), or None ("rmw"/"fused": the scatter-add)."""
    if scatter == "ranksum":
        return CR.RanksumPlan(*BN.build_ranksum_plan(
            sub_lists, n_surfels, group=CR.RS_GROUP, gps=CR.RS_GPS,
            trunc_frac=CR.RS_TRUNC))
    if scatter == "plan":
        return CR.scatter_plan(sub_lists, n_surfels)
    return None


def _snake_deal(counts: torch.Tensor, mesh):
    """Balanced deal of the tiles over "data": rank tiles by count
    (descending, stable), deal rank r to data rank r % n with odd rounds
    reversed, so every rank gets one tile of each count stratum.  Returns
    (this rank's tiles [t_local], the permutation from the gathered tile
    order to tile order [n_tiles])."""
    n = mesh.data
    order = torch.sort(-counts, stable=True).indices
    mat = order.reshape(-1, n).clone()
    mat[1::2] = mat[1::2].flip(1)
    mine = mat[:, mesh.data_index]
    # gathered tile row d*t_local + j holds global tile mat[j, d]
    scatter_perm = mat.T.reshape(-1)
    return mine, torch.argsort(scatter_perm)


def _subset(tiles: CR.TileAssignment, mine, n_surfels: int, scatter: str):
    sub_lists = tiles.lists[mine]
    return CR.TileAssignment(
        lists=sub_lists, counts=tiles.counts[mine],
        rays_t=tiles.rays_t[mine], pix_t=tiles.pix_t[mine],
        plan=_maybe_plan(sub_lists, n_surfels, scatter))


def _raster_tiles(p: S.SurfelParams, active, T_cw, K, sub, static):
    """Kernel output [t, P, 8] of a tile subset (K1; K2 + reduction in the
    backward)."""
    scaling = torch.exp(p.log_scale)
    opacity = torch.sigmoid(p.logit_opacity) * active
    packed = CM.pack_surfels(p.xyz, scaling, p.quat, opacity, T_cw, K)
    F = BN.pack_features(packed)
    plans = None if sub.plan is None else (sub.plan,)
    return CR._RasterCore.apply(F, sub.lists, sub.counts, sub.rays_t,
                                sub.pix_t, static, plans), scaling


def _tile_space_loss(out_depth_sum, alpha, normal_sum, median, kf_T, kf_K,
                     gt_img, valid_img, mine, inv_perm, mesh,
                     params: RenderParams, mc, depth_ratio: float):
    """The channel losses of a tile subset; the one cross-tile term,
    surf_normal's finite differences, all-gathers the depth image over
    "data" (its backward reduce-scatters the cotangent)."""
    height, width = params.height, params.width
    th, tw = params.tile_h, params.tile_w
    R_wc = kf_T[:3, :3].T
    surf_depth_t, rend_normal = _decode(out_depth_sum, alpha, normal_sum,
                                        median, R_wc, depth_ratio)
    gath = C.all_gather(surf_depth_t, mesh.group("data"))
    depth_img = BN.untile_image(gath[inv_perm], height, width, th, tw)
    normals = spherical.depth_to_normal(depth_img, kf_K,
                                        se3.invert_T(kf_T))
    surf_normal = BN.tile_image(normals, th, tw)[mine] * alpha[..., None]
    validf_img = valid_img.to(torch.float32)
    v_sum = torch.clamp(torch.sum(validf_img), min=1.0)
    gt_t = BN.tile_image(gt_img, th, tw)[mine]
    validf = BN.tile_image(validf_img, th, tw)[mine]
    return _channel_sums(surf_depth_t, alpha, rend_normal, surf_normal,
                         gt_t, validf, mc, height * width, v_sum)


class ShardedOptimize:
    """A sharded optimize loop: ``(surf_shard, adam_shard, kf, kf_indices)
    -> (surf_shard, adam_shard, loss EMA, iterations run)``, the
    single-device schedule of MapperPrograms.optimize (rebin blocks, EMA
    early stopping) with each iteration sharded.  ``make_tiles``,
    ``one_iter`` and ``reshard`` are the loop's steps."""

    def __init__(self, mesh, params: RenderParams, hyper: S.AdamHyper, mc,
                 compute_cfg, depth_ratio: float):
        self.mesh, self.params, self.hyper = mesh, params, hyper
        self.mc, self.depth_ratio = mc, depth_ratio
        self.compact = bool(getattr(compute_cfg, "compact_param_comms",
                                    False))
        self.rebin = max(1, int(compute_cfg.rebin_every))
        self.margin_px = float(compute_cfg.bin_margin_px)
        self.reshard = None

    def make_tiles(self, surf, kf, kf_idx):
        raise NotImplementedError

    # grads() gives the whole pool's gradient (FSDP: each rank keeps its
    # rows), not the rank's own rows' (the ring's band)
    whole_pool = True

    def grads(self, surf, kf, kf_idx, tiles):
        """-> (loss, gradient): of the whole pool on the FSDP partitions,
        of the rank's band on the ring."""
        raise NotImplementedError

    def one_iter(self, surf, st, kf, kf_idx, tiles):
        loss, grads = self.grads(surf, kf, kf_idx, tiles)
        if self.whole_pool:
            grads = _slice_model(grads, self.mesh)
        surf2, st2 = S.adam_step(surf, st, grads, self.hyper)
        return surf2, st2, loss

    def _stall_from_root(self, stalled: torch.Tensor) -> torch.Tensor:
        # every rank stops after the same block: rank 0's count decides
        return C.broadcast_(stalled.clone(), self.mesh.group("world"))

    def __call__(self, surf_shard, adam_shard, kf, kf_indices):
        from ..slam.mapper import run_block_loop
        mc, rebin = self.mc, self.rebin
        reshard = (None if self.reshard is None else
                   lambda s, a, i: self.reshard(s, a, kf, i))
        return run_block_loop(
            surf_shard, adam_shard, kf_indices,
            num_iters=mc.num_iterations + 1, rebin=rebin,
            early=bool(mc.early_stop_enable),
            patience_blocks=max(1, int((mc.early_stop_patience or 100)
                                       // rebin)),
            es_threshold=float(mc.early_stop_threshold or 0.01),
            make_tiles=lambda s, i: self.make_tiles(s, kf, i),
            one_iter=lambda s, a, i, t: self.one_iter(s, a, kf, i, t),
            reshard=reshard, stall_from_root=self._stall_from_root)


class _RowsOptimize(ShardedOptimize):
    def __init__(self, *args):
        super().__init__(*args)
        if self.params.height % self.mesh.data:
            raise ValueError(f"height {self.params.height} not divisible "
                             f"by parallel.data={self.mesh.data}")

    def make_tiles(self, surf, kf, kf_idx):
        if _resolve_backend(self.params.backend) == "eager":
            return None
        full = _gather_params(surf.params, self.mesh, self.compact)
        active = _gather_active(surf.active, self.mesh)
        return _row_tiles(full, active, kf.T_cw[kf_idx], kf.K[kf_idx],
                          self.params, self.mesh, self.margin_px)

    def grads(self, surf, kf, kf_idx, tiles):
        return _fsdp_grads(
            surf, self.mesh, self.compact,
            lambda p, active: _rows_loss(
                p, active, kf.T_cw[kf_idx], kf.K[kf_idx], kf.depth[kf_idx],
                kf.valid[kf_idx], self.mesh, self.params, self.mc,
                self.depth_ratio, tiles=tiles))


def _require_kernel_path(params: RenderParams, partition: str) -> None:
    if _resolve_backend(params.backend) != "cuda":
        raise ValueError(f"parallel.partition={partition!r} renders tile "
                         f"subsets and needs the cuda backend (the eager "
                         f"renderer has no tile decomposition); use 'rows'")
    if params.layout != "tiled":
        raise ValueError(f"parallel.partition={partition!r} needs the "
                         f"tiled layout")


def _tile_count(params: RenderParams, mesh) -> int:
    n_tiles = (params.height // params.tile_h) * \
        (params.width // params.tile_w)
    if n_tiles % mesh.data:
        raise ValueError(f"{n_tiles} tiles not divisible by "
                         f"parallel.data={mesh.data}")
    return n_tiles


class _TilesOptimize(ShardedOptimize):
    """Balanced tile-level data parallelism: at each rebin point the tiles
    are ordered by binning count and dealt snake-wise over "data"; losses
    are computed in tile space, the tile grid covering every pixel once."""

    def __init__(self, *args):
        super().__init__(*args)
        _require_kernel_path(self.params, "tiles")
        _tile_count(self.params, self.mesh)
        self.static = CR._static(self.params)

    def make_tiles(self, surf, kf, kf_idx):
        full = _gather_params(surf.params, self.mesh, self.compact)
        active = _gather_active(surf.active, self.mesh)
        tiles = prepare_tiles(full.xyz, torch.exp(full.log_scale), full.quat,
                              torch.sigmoid(full.logit_opacity) * active,
                              kf.T_cw[kf_idx], kf.K[kf_idx], self.params,
                              margin_px=self.margin_px)
        mine, inv_perm = _snake_deal(tiles.counts, self.mesh)
        return (_subset(tiles, mine, full.xyz.shape[0], self.params.scatter),
                mine, inv_perm)

    def grads(self, surf, kf, kf_idx, tiles3):
        sub, mine, inv_perm = tiles3
        T_cw, K = kf.T_cw[kf_idx], kf.K[kf_idx]

        def loss_fn(p, active):
            out, scaling = _raster_tiles(p, active, T_cw, K, sub,
                                         self.static)
            chan = _tile_space_loss(
                out[..., 0], out[..., 1], out[..., 2:5], out[..., 5], T_cw,
                K, kf.depth[kf_idx], kf.valid[kf_idx], mine, inv_perm,
                self.mesh, self.params, self.mc, self.depth_ratio)
            return chan + _scale_penalty(scaling, active, self.mc,
                                         self.mesh.data)

        return _fsdp_grads(surf, self.mesh, self.compact, loss_fn)


class _RingOptimize(ShardedOptimize):
    """Ring compositing over "model" depth bands x tile-DP over "data": an
    iteration never materialises the pool.  Once per rebin block the pool
    is re-partitioned depth-contiguously for the block's view
    (ring_reshard); each rank bins and renders only its band, the bands'
    segment states fold front to back (ring_fold), and the band's
    gradient stays on its rank, summed over "data" only."""

    whole_pool = False

    def __init__(self, *args):
        super().__init__(*args)
        if self.depth_ratio != 0.0:
            raise ValueError("ring compositing does not fold the median "
                             "channel: it needs opt.depth_ratio == 0")
        _require_kernel_path(self.params, "ring")
        _tile_count(self.params, self.mesh)
        self.static = CR._static(self.params._replace(with_median=False,
                                                      with_dist=False))
        self.reshard = self._reshard

    def _reshard(self, surf, st, kf, kf_idx):
        T_cw = kf.T_cw[kf_idx]
        p = surf.params.xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        d_key = torch.where(surf.active, torch.linalg.norm(p, dim=-1),
                            float("inf"))
        return ring_reshard(surf, st, d_key, self.mesh.group("model"))

    def make_tiles(self, surf, kf, kf_idx):
        p = surf.params
        tiles = prepare_tiles(p.xyz, torch.exp(p.log_scale), p.quat,
                              torch.sigmoid(p.logit_opacity) * surf.active,
                              kf.T_cw[kf_idx], kf.K[kf_idx], self.params,
                              margin_px=self.margin_px)
        # deal from the GLOBAL per-tile load, so every model rank picks
        # the same tile subsets
        counts_tot = C.all_reduce_(tiles.counts.clone(),
                                   self.mesh.group("model"))
        mine, inv_perm = _snake_deal(counts_tot, self.mesh)
        return (_subset(tiles, mine, p.xyz.shape[0], self.params.scatter),
                mine, inv_perm)

    def grads(self, surf, kf, kf_idx, tiles3):
        sub, mine, inv_perm = tiles3
        mesh, mc = self.mesh, self.mc
        T_cw, K = kf.T_cw[kf_idx], kf.K[kf_idx]
        active = surf.active
        p = S.SurfelParams(*(a.detach().requires_grad_(True)
                             for a in surf.params))
        out, scaling = _raster_tiles(p, active, T_cw, K, sub, self.static)
        ch = ring_fold(dict(T=out[..., 7], depth_sum=out[..., 0],
                            alpha=out[..., 1], normal_sum=out[..., 2:5]),
                       mesh.group("model"))
        chan = _tile_space_loss(
            ch["depth_sum"], ch["alpha"], ch["normal_sum"], None, T_cw, K,
            kf.depth[kf_idx], kf.valid[kf_idx], mine, inv_perm, mesh,
            self.params, mc, 0.0)
        # every rank's gradient is d(sum of all ranks' losses)/d(its band):
        # the channel losses come out of the fold replicated over "model"
        # (/n_model); the band-local scale penalty appears once per band
        # but on every "data" rank (/n_data)
        loss_local = chan / mesh.model + _scale_penalty(scaling, active, mc,
                                                        mesh.data)
        grads = S.SurfelParams(*torch.autograd.grad(loss_local, p))
        grads, loss = _sum_over_data(grads, loss_local, mesh)
        # summed over both axes the pre-divisions cancel: the same
        # chan_total + reg_total on every rank
        loss = C.all_reduce_(loss.reshape(1).clone(),
                             mesh.group("model"))[0]
        return loss, grads


def sharded_optimize(mesh, params, hyper, mc, compute_cfg,
                     depth_ratio: float = 0.0) -> ShardedOptimize:
    """The "rows" partition: row-block DP over "data" x FSDP over
    "model"; any backend."""
    return _RowsOptimize(mesh, params, hyper, mc, compute_cfg, depth_ratio)


def sharded_optimize_tiles(mesh, params, hyper, mc, compute_cfg,
                           depth_ratio: float = 0.0) -> ShardedOptimize:
    """The "tiles" partition (cuda backend): count-balanced tile DP over
    "data" x FSDP over "model"."""
    return _TilesOptimize(mesh, params, hyper, mc, compute_cfg, depth_ratio)


def sharded_optimize_ring(mesh, params, hyper, mc, compute_cfg,
                          depth_ratio: float = 0.0) -> ShardedOptimize:
    """The "ring" partition (cuda backend): depth bands over "model" with
    ring compositing x tile DP over "data"."""
    return _RingOptimize(mesh, params, hyper, mc, compute_cfg, depth_ratio)


def sharded_densify(mesh, params: RenderParams, mc, max_new: int,
                    depth_ratio: float = 0.0) -> dict:
    """Sharded densification: the render is row-DP over "data"; the mask,
    top-k, KNN and insertion run on every rank on the gathered pool
    (densify_core, as on one device), and each rank keeps its "model"
    slice of the result.

    Returns {initialize: fn(surf_shard, adam_shard, camera, gumbel) ->
    (surf_shard, adam_shard, n_written, sampled mask [H, W])}."""
    from ..slam.mapper import densify_core

    height, width = params.height, params.width
    if height % mesh.data:
        raise ValueError(f"height {height} not divisible by "
                         f"parallel.data={mesh.data}")

    def build(initialize: bool):
        def dens(surf_shard: S.Surfels, adam_shard: S.AdamState,
                 cam: Camera, gumbel: torch.Tensor):
            surf_full, adam_full = gather_model_state(mesh, surf_shard,
                                                      adam_shard)
            pkg = None
            if not initialize:
                g = mesh.group("data")
                with torch.no_grad():
                    surf_depth, alpha, *_ = _render_rows(
                        surf_full.params, surf_full.active, cam.T_cw,
                        cam.K, mesh, params._replace(scatter="rmw"),
                        depth_ratio)
                    pkg = {"rend_alpha": C.all_gather_raw(alpha, g),
                           "surf_depth": C.all_gather_raw(surf_depth, g)}
            surf2, adam2, n_written, sampled = densify_core(
                surf_full, adam_full, cam, gumbel, pkg, mc=mc,
                max_new=max_new, height=height, width=width)
            surf_out, adam_out = shard_model_state(mesh, surf2, adam2)
            return surf_out, adam_out, n_written, sampled
        return dens

    return {True: build(True), False: build(False)}


def sharded_prune(mesh, mc):
    """Prune on sharded state: elementwise over the pool, so each "model"
    rank prunes its slice; the count is summed over "model"."""
    from ..slam.mapper import prune_core

    def prune(surf_shard: S.Surfels):
        surf2, n_local = prune_core(surf_shard, mc=mc)
        n = C.all_reduce_(n_local.reshape(1).to(torch.int64),
                          mesh.group("model"))
        return surf2, n[0]

    return prune
