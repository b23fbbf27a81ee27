"""Mapper: densify -> optimize -> prune.

Counterpart of splatloam_tpu/slam/mapper.py:

  * densify: candidate mask from the rendered alpha + optional depth-error
    quantile; weighted sampling without replacement by Gumbel-top-k;
    back-projection; KNN scale init; normal-aligned rotations; writes
    into free surfel slots.
  * optimize: a loop over rebin blocks of Adam iterations, each block on
    one keyframe drawn from the geometric replay distribution (or
    ``mapping.views_per_iteration`` keyframes drawn with replacement,
    rendered in one batched pass and their losses averaged), with the
    paper's losses (Eq 15-17) and EMA early stopping.  The image losses
    come from ``api.render_loss``: on CUDA the forward's output goes
    straight into K11, which writes the losses and their cotangent for
    the backward (each update adds its K11 launches to the profiler's
    ``kernel.K11_image_loss``).  On CUDA each block
    is a captured CUDA graph (graphs.CapturedProgram over StaticBlock's
    buffers), the counterpart of the JAX package's jitted
    ``while_loop``: the host replays one graph per block and reads the
    stall count between blocks.  On the CPU, under the debug checks, and
    where a caller asks (``optimize(capture=False)``), the blocks run
    uncaptured through ``run_block_loop``.
  * prune: mask-clear by opacity/scale thresholds.

With ``parallel.data * parallel.model`` > 1 the three steps run through
the sharded programs of parallel/sharded.py, one process per rank.

Randomness comes from a ``torch.Generator`` owned by ``Mapper``;
``densify_core`` and ``run_block_loop`` take the Gumbel noise and the
per-block keyframe indices as tensors, so a caller can hand both packages
the same draws.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import debug, graphs
from ..config import Configuration
from ..device import resolve_device
from ..geometry import se3, spherical
from ..logging_backends import get_datalogger
from ..logging_utils import get_logger
from ..model import surfels as S
from ..model.camera import Camera
from ..model.frame import Frame
from ..model.local_model import LocalModel
from ..ops import knn
from ..ops.rasterizer import kernels
from ..ops.rasterizer.api import (RenderParams, adaptive_geometry,
                                  fit_geometry, image_losses, prepare_tiles,
                                  prepare_tiles_batch, render, render_batch,
                                  render_loss)
from ..profiling import get_profiler

logger = get_logger("mapper")


class KeyframeBatch(NamedTuple):
    """Padded stack of keyframe cameras, leading dim [K_cap]."""
    K: torch.Tensor       # [Kc, 3, 3]
    T_cw: torch.Tensor    # [Kc, 4, 4]
    depth: torch.Tensor   # [Kc, H, W]
    valid: torch.Tensor   # [Kc, H, W] bool
    probs: np.ndarray     # [Kc] replay distribution (0 on padding)


def sample_geometric_probs(n: int, last_kf_prob: float | None,
                           kf_cap: int) -> np.ndarray:
    """Keyframe replay distribution, padded to kf_cap: P(kf i)
    proportional to (1-p)^(i-1) * p over the insertion-ordered list;
    uniform when p is None/negative; delta when one keyframe."""
    if n == 1:
        probs = np.array([1.0])
    elif last_kf_prob is None or last_kf_prob < 0.0:
        probs = np.full((n,), 1.0 / n)
    else:
        i = np.arange(1, n + 1, dtype=np.float64)
        probs = (1.0 - last_kf_prob) ** (i - 1) * last_kf_prob
        probs /= probs.sum()
    out = np.zeros((kf_cap,), np.float32)
    out[:n] = probs
    return out


def take(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` along the leading axis for a keyframe index ``idx`` (an
    int, or a [] or [B] integer tensor) without reading a tensor index on
    the host, as indexing with a 0-d tensor does."""
    if not torch.is_tensor(idx):
        return x[idx]
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                      *x.shape[1:])


def run_block(surfels, adam, kf_idx, tiles, ema, best, stalled, *,
              rebin: int, es_threshold: float, one_iter):
    """One rebin block: ``rebin`` iterations of ``one_iter`` on frozen
    tiles with the loss EMA, then the block's early-stopping update.
    Returns (surfels, adam, ema, best, stalled)."""
    for _ in range(rebin):
        surfels, adam, loss = one_iter(surfels, adam, kf_idx, tiles)
        ema = torch.where(torch.isnan(ema), loss, 0.1 * loss + 0.9 * ema)
    improved = ema < best * (1.0 - es_threshold)
    best = torch.minimum(best, ema)
    stalled = torch.where(improved, 0, stalled + 1)
    return surfels, adam, ema, best, stalled


def run_block_loop(surfels, adam, kf_indices, *, num_iters: int, rebin: int,
                   early: bool, patience_blocks: int, es_threshold: float,
                   make_tiles, one_iter, reshard=None, stall_from_root=None):
    """Optimize scaffold: a loop over rebin blocks with EMA early stopping.

    kf_indices [n_blocks] holds each block's keyframe index, or
    [n_blocks, views] its keyframe indices;
    make_tiles(surfels, kf_idx) -> frozen tile assignment (or None);
    one_iter(surfels, adam, kf_idx, tiles) -> (surfels, adam, loss);
    reshard(surfels, adam, kf_idx) -> (surfels, adam), an optional
    shape-preserving re-layout at each block start (the ring partition's
    per-view depth bands; slot order may change, every consumer goes
    through the active mask).
    Returns (surfels, adam, loss EMA, iterations run).  With ``early`` the
    host reads the stall count once per block, through
    ``stall_from_root`` when given (the sharded programs pass rank 0's
    count, so every rank stops after the same block).
    """
    n_blocks = (num_iters + rebin - 1) // rebin
    if kf_indices.shape[0] < n_blocks:
        raise ValueError(f"{kf_indices.shape[0]} keyframe indices for "
                         f"{n_blocks} blocks")
    dev = surfels.active.device
    ema = torch.tensor(float("nan"), device=dev)
    best = torch.tensor(float("inf"), device=dev)
    stalled = torch.zeros((), dtype=torch.int32, device=dev)
    b = 0
    while b < n_blocks:
        if early:
            count = (stalled if stall_from_root is None
                     else stall_from_root(stalled))
            if int(count) >= patience_blocks:
                break
        kf_idx = kf_indices[b]
        if reshard is not None:
            surfels, adam = reshard(surfels, adam, kf_idx)
        tiles = make_tiles(surfels, kf_idx)
        surfels, adam, ema, best, stalled = run_block(
            surfels, adam, kf_idx, tiles, ema, best, stalled, rebin=rebin,
            es_threshold=es_threshold, one_iter=one_iter)
        b += 1
    return surfels, adam, ema, b * rebin


def densify_core(surfels: S.Surfels, adam: S.AdamState, camera: Camera,
                 gumbel: torch.Tensor, pkg, *, mc, max_new: int,
                 height: int, width: int):
    """Densification on full-image channels.

    ``gumbel`` [H*W] is standard Gumbel noise; ``pkg`` is None on model
    initialization, else a dict with ``rend_alpha`` / ``surf_depth``.
    Returns (surfels, adam, n_written, sampled mask [H, W]).
    """
    valid = camera.valid
    dev = valid.device
    if pkg is None:
        densify_mask = valid
    else:
        mask_opacity = pkg["rend_alpha"] <= mc.densify_threshold_opacity
        densify_mask = mask_opacity & valid
        if mc.densify_threshold_egeom > 0.0:
            est = pkg["surf_depth"]
            geom_loss = torch.abs(camera.depth - est) * valid
            q95 = torch.quantile(geom_loss, 0.95)
            mask_depth = (est > camera.depth) & (geom_loss > q95)
            densify_mask = densify_mask | mask_depth

    n_cand = torch.sum(densify_mask)
    n_samples = (mc.densify_percentage * n_cand).to(torch.int32)

    grad = spherical.depth_gradient(camera.depth, valid)
    grad = grad / torch.clamp(torch.max(grad), min=1e-12)
    weight = torch.where(densify_mask, grad, 0.0).reshape(-1)
    # no-op conditions: <2 samples or all-zero weights
    do_densify = (n_samples >= 2) & (torch.sum(weight) > 1e-5)
    n_samples = torch.minimum(n_samples,
                              torch.sum(weight > 0).to(torch.int32))
    n_samples = torch.where(do_densify, n_samples, 0)

    # Gumbel-top-k == weighted sampling without replacement
    scores = torch.where(weight > 0, torch.log(weight) + gumbel,
                         float("-inf"))
    flat_idx = torch.topk(scores, max_new).indices
    chosen = torch.arange(max_new, device=dev) < torch.clamp(n_samples,
                                                             max=max_new)

    pts_model = spherical.depth_to_points(
        camera.depth, camera.K, se3.invert_T(camera.T_cw))
    new_xyz = pts_model.reshape(-1, 3)[flat_idx]

    # scale init: 3-NN over (new + existing) points
    all_pts = torch.cat([new_xyz, surfels.params.xyz])
    all_mask = torch.cat([chosen, surfels.active])
    d2 = knn.mean_sq_dist_knn(all_pts, all_mask)[:max_new]
    d2 = torch.clamp(d2, 1e-7, mc.opt_scaling_max ** 2)
    new_log_scale = (0.5 * torch.log(d2))[:, None].repeat(1, 2)

    # rotation init: sensor-frame normals -> model frame
    R_mf = camera.T_cw[:3, :3].T
    n_img = camera.normal.reshape(-1, 3)[flat_idx]
    n_model = n_img @ R_mf.T
    # guard degenerate normals for padding rows
    n_norm = torch.linalg.norm(n_model, dim=-1, keepdim=True)
    n_model = torch.where(n_norm > 1e-6, n_model,
                          n_model.new_tensor([0.0, 0.0, 1.0]))
    new_quat = se3.quat_from_normal(n_model)

    new_logit_op = torch.full((max_new,), S.inverse_sigmoid(0.9),
                              dtype=torch.float32, device=dev)
    new_params = S.SurfelParams(xyz=new_xyz, log_scale=new_log_scale,
                                quat=new_quat, logit_opacity=new_logit_op)
    surfels, adam, n_written = S.insert_surfels(surfels, adam, new_params,
                                                n_samples)

    sampled_mask = torch.zeros((height * width,), dtype=torch.bool,
                               device=dev)
    sampled_mask[flat_idx] = chosen
    return surfels, adam, n_written, sampled_mask.reshape(height, width)


def scale_penalty(scaling, active, mc):
    """Eq 17: scale-overflow penalty on active surfels."""
    # amax splits the gradient between tied scales, as jnp.max does
    smax = torch.amax(scaling, dim=-1)
    # maximum (not clamp) halves the gradient at a tie, as jnp.maximum
    # does: a scale initialized at exactly opt_scaling_max sits there
    over = torch.maximum(smax - mc.opt_scaling_max,
                         torch.zeros_like(smax)) * active
    return mc.opt_scaling_max_penalty * torch.sum(over)


def prune_core(surfels: S.Surfels, *, mc):
    """Prune mask by opacity/scale thresholds -> (surfels, n_pruned)."""
    prune = torch.zeros((surfels.capacity,), dtype=torch.bool,
                        device=surfels.active.device)
    if mc.pruning_min_opacity and mc.pruning_min_opacity > 0:
        op = torch.sigmoid(surfels.params.logit_opacity)
        prune = prune | (op < mc.pruning_min_opacity)
    if mc.pruning_min_size and mc.pruning_min_size > 0:
        snorm = torch.linalg.norm(torch.exp(surfels.params.log_scale),
                                  dim=-1)
        prune = prune | (snorm < mc.pruning_min_size)
    prune = prune & surfels.active
    return S.prune_surfels(surfels, prune), torch.sum(prune)


def _tensors(tree) -> list:
    """The tensors of a tree of named tuples, in order (None skipped)."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    return [t for x in tree for t in _tensors(x)]


def _clone_tree(tree):
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.clone()
    return type(tree)(*(_clone_tree(x) for x in tree))


class StaticBlock:
    """One rebin block on fixed buffers: the body a captured graph holds.

    The buffers hold the pool (its four parameter tensors and ``active``),
    Adam's moments and step, the keyframe stack, the block's keyframe
    index, the loss EMA, its best value and the stalled-block count, and,
    where the rebin reads values back to the host (the programs'
    ``rebin_outside``), the tile lists and plan the host rebins into once
    per block.  ``body``
    runs one block (``run_block``, after the rebin when it is inside) and
    writes the pool, Adam's state and the early-stopping state back into
    the same buffers, so the next block runs on them with no copy.
    """

    def __init__(self, progs: "MapperPrograms", surfels: S.Surfels,
                 adam: S.AdamState, kf: KeyframeBatch, kf_idx: torch.Tensor):
        def c(t):
            return t.detach().clone()

        self.progs = progs
        self.params = S.SurfelParams(*map(c, surfels.params))
        self.active = c(surfels.active)
        self.mu = S.SurfelParams(*map(c, adam.mu))
        self.nu = S.SurfelParams(*map(c, adam.nu))
        self.step = c(adam.step)
        self.kf = KeyframeBatch(K=c(kf.K), T_cw=c(kf.T_cw), depth=c(kf.depth),
                                valid=c(kf.valid), probs=kf.probs)
        self.kf_idx = c(kf_idx)
        dev = self.active.device
        self.ema = torch.full((), float("nan"), device=dev)
        self.best = torch.full((), float("inf"), device=dev)
        self.stalled = torch.zeros((), dtype=torch.int32, device=dev)
        self.tiles = None

    def _state(self) -> tuple:
        return (*self.params, *self.mu, *self.nu, self.step, self.ema,
                self.best, self.stalled)

    def tensors(self) -> list:
        """Every buffer, the tile lists and plan included once set."""
        return [*self._state(), self.active, self.kf.K, self.kf.T_cw,
                self.kf.depth, self.kf.valid, self.kf_idx,
                *_tensors(self.tiles)]

    def load(self, surfels: S.Surfels, adam: S.AdamState,
             kf: KeyframeBatch) -> None:
        """An update's start: its pool, Adam state and keyframes, and a
        fresh early-stopping state."""
        for dst, src in zip(
                (*self.params, self.active, *self.mu, *self.nu, self.step,
                 self.kf.K, self.kf.T_cw, self.kf.depth, self.kf.valid),
                (*surfels.params, surfels.active, *adam.mu, *adam.nu,
                 adam.step, kf.K, kf.T_cw, kf.depth, kf.valid)):
            dst.copy_(src)
        self.ema.fill_(float("nan"))
        self.best.fill_(float("inf"))
        self.stalled.zero_()

    def surfels(self) -> S.Surfels:
        return S.Surfels(self.params, self.active)

    def start_block(self, kf_idx: torch.Tensor) -> None:
        """The block's keyframe index, and its tiles when the rebin runs
        outside the graph."""
        self.kf_idx.copy_(kf_idx)
        if not self.progs.rebin_outside:
            return
        tiles = self.progs.make_tiles(self.surfels(), self.kf, self.kf_idx)
        if self.tiles is None:
            self.tiles = _clone_tree(tiles)
        else:
            for dst, src in zip(_tensors(self.tiles), _tensors(tiles)):
                dst.copy_(src)

    def body(self) -> None:
        progs = self.progs
        surf = self.surfels()
        adam = S.AdamState(self.mu, self.nu, self.step)
        tiles = (self.tiles if progs.rebin_outside
                 else progs.make_tiles(surf, self.kf, self.kf_idx))
        surf, adam, ema, best, stalled = run_block(
            surf, adam, self.kf_idx, tiles, self.ema, self.best,
            self.stalled, rebin=progs.rebin, es_threshold=progs.es_threshold,
            one_iter=lambda s, a, i, t: progs.one_iter(s, a, self.kf, i, t))
        for dst, src in zip(self._state(),
                            (*surf.params, *adam.mu, *adam.nu, adam.step,
                             ema, best, stalled)):
            dst.copy_(src)

    def results(self, active: torch.Tensor):
        """(surfels, adam, ema) as copies that outlive the buffers."""
        def c(t):
            return t.clone()
        return (S.Surfels(S.SurfelParams(*map(c, self.params)), active),
                S.AdamState(mu=S.SurfelParams(*map(c, self.mu)),
                            nu=S.SurfelParams(*map(c, self.nu)),
                            step=c(self.step)),
                c(self.ema))


class MapperPrograms:
    """Mapping steps specialized to (H, W, capacity).  On CUDA the optimize
    blocks run as captured graphs, one per signature (``signature``),
    kept until ``release_graphs``."""

    def __init__(self, cfg: Configuration, height: int, width: int,
                 capacity: int):
        self.cfg = cfg
        mc, oc, cc = cfg.mapping, cfg.opt, cfg.compute
        self.height, self.width, self.capacity = height, width, capacity
        if cc.auto_tile:
            geo = fit_geometry(adaptive_geometry(capacity), height, width)
            tile_h, tile_w = geo["tile_h"], geo["tile_w"]
            chunk, cap_k = geo["chunk"], geo["tile_list_capacity"]
        else:
            tile_h, tile_w = cc.tile_h, cc.tile_w
            chunk, cap_k = cc.chunk, cc.tile_list_capacity
        # tile lists can't usefully exceed ~capacity/8 entries; shrink K
        # for small pools
        k_eff = min(int(cap_k),
                    max(int(chunk), (capacity // 8 // chunk) * chunk))
        self.params = RenderParams(
            height=height, width=width, backend=cc.backend.value,
            chunk=chunk, tile_h=tile_h, tile_w=tile_w,
            tile_list_capacity=k_eff, scatter=cc.scatter,
            # the mapping losses use expected depth only (+ median iff
            # depth_ratio > 0); the distortion channel is never in the loss
            with_median=oc.depth_ratio > 0, with_dist=False)
        self.views = max(1, int(mc.views_per_iteration or 1))
        self.max_new = int(np.ceil(
            max(mc.densify_percentage, 1e-3) * height * width)) + 1
        self.hyper = S.AdamHyper(lr_xyz=oc.position_lr,
                                 lr_scale=oc.scaling_lr,
                                 lr_quat=oc.rotation_lr,
                                 lr_opacity=oc.opacity_lr)
        # amortized rebinning: a keyframe view + its tile lists are held
        # fixed for rebin_every consecutive Adam steps (exact when 1; the
        # binning radius carries a pixel margin to absorb parameter drift)
        self.rebin = max(1, int(cc.rebin_every))
        self.early = bool(mc.early_stop_enable)
        self.patience_blocks = max(1, int((mc.early_stop_patience or 100)
                                          // self.rebin))
        self.es_threshold = float(mc.early_stop_threshold or 0.01)
        # the "plan" rebin assigns through a boolean mask, which reads
        # back to the host: it runs outside the graph, once per block
        self.rebin_outside = cc.scatter == "plan"
        # signature -> (StaticBlock, CapturedProgram)
        self._graphs: dict[tuple, tuple] = {}
        self._said_uncaptured = False

    def densify(self, surfels: S.Surfels, adam: S.AdamState,
                camera: Camera, gumbel: torch.Tensor, *, initialize: bool):
        prof = get_profiler()
        pkg = None
        if not initialize:
            with prof.phase("map.densify.render"), torch.no_grad():
                pkg = render(surfels.params.xyz, surfels.scaling,
                             surfels.rotation, surfels.opacity, camera.T_cw,
                             camera.K, self.params, self.cfg.opt.depth_ratio)
        with prof.phase("map.densify.core"):
            return densify_core(surfels, adam, camera, gumbel, pkg,
                                mc=self.cfg.mapping, max_new=self.max_new,
                                height=self.height, width=self.width)

    def _image_losses(self, pkg, gt_depth, valid):
        """Depth L1 + Eq 16 + Eq 15 of each view, over the last two (H, W)
        dims of a render package (api.image_losses with this config's
        weights).  The optimize iterations take these losses through
        ``render_loss`` (K11 on CUDA) unless an instance replaces this
        method, as the benchmark's half_batch fault does
        (benchmark/faults.py): ``_view_losses`` then renders and calls the
        replacement.  Kept for that fault, until it is planted where K11
        reads."""
        mc = self.cfg.mapping
        return image_losses(pkg, gt_depth, valid, mc.opt_lambda_normal,
                            mc.opt_lambda_alpha)

    def _scale_penalty(self, scaling, active):
        return scale_penalty(scaling, active, self.cfg.mapping)

    def _view_losses(self, params: S.SurfelParams, active, kf: KeyframeBatch,
                     kf_idx, tiles):
        """(each view's image loss, the activated scales) at the keyframe
        index ``kf_idx`` (0-d: a 0-d loss; [B]: loss [B])."""
        mc = self.cfg.mapping
        scaling = torch.exp(params.log_scale)
        opacity = torch.sigmoid(params.logit_opacity) * active
        T_cw, K = take(kf.T_cw, kf_idx), take(kf.K, kf_idx)
        depth, valid = take(kf.depth, kf_idx), take(kf.valid, kf_idx)
        if "_image_losses" in vars(self):
            # K11 computes this class's _image_losses, not a replacement
            draw = render if T_cw.dim() == 2 else render_batch
            pkg = draw(params.xyz, scaling, params.quat, opacity, T_cw, K,
                       self.params, self.cfg.opt.depth_ratio, tiles=tiles)
            return self._image_losses(pkg, depth, valid), scaling
        loss = render_loss(params.xyz, scaling, params.quat, opacity, T_cw,
                           K, depth, valid, self.params,
                           lambda_normal=mc.opt_lambda_normal,
                           lambda_alpha=mc.opt_lambda_alpha,
                           depth_ratio=self.cfg.opt.depth_ratio, tiles=tiles)
        return loss, scaling

    def _loss(self, params: S.SurfelParams, active, kf: KeyframeBatch,
              kf_idx, tiles=None):
        loss, scaling = self._view_losses(params, active, kf, kf_idx, tiles)
        return loss + self._scale_penalty(scaling, active)

    def _loss_multi(self, params: S.SurfelParams, active, kf: KeyframeBatch,
                    kf_idx, tiles=None):
        """views_per_iteration > 1: the mean of the per-view losses of the
        keyframes kf_idx [B], rendered through one batched pass (on the
        cuda backend the mean is each view's 1/B in K11's backward)."""
        loss, scaling = self._view_losses(params, active, kf, kf_idx, tiles)
        return torch.mean(loss) + self._scale_penalty(scaling, active)

    def one_iter(self, surf: S.Surfels, st: S.AdamState, kf: KeyframeBatch,
                 kf_idx, tiles):
        """One Adam iteration: loss, gradients, masked Adam step."""
        params = S.SurfelParams(*(p.detach().requires_grad_(True)
                                  for p in surf.params))
        loss_fn = self._loss if self.views == 1 else self._loss_multi
        loss = loss_fn(params, surf.active, kf, kf_idx, tiles)
        grads = S.SurfelParams(*torch.autograd.grad(loss, params))
        surf, st = S.adam_step(surf, st, grads, self.hyper)
        return surf, st, loss.detach()

    def make_tiles(self, surf: S.Surfels, kf: KeyframeBatch, kf_idx):
        """The rebin: frozen tile lists (and the reduction's plan) of the
        keyframe view(s) ``kf_idx``."""
        scaling = torch.exp(surf.params.log_scale)
        opacity = torch.sigmoid(surf.params.logit_opacity) * surf.active
        prep = prepare_tiles if self.views == 1 else prepare_tiles_batch
        return prep(surf.params.xyz, scaling, surf.params.quat, opacity,
                    take(kf.T_cw, kf_idx), take(kf.K, kf_idx), self.params,
                    margin_px=self.cfg.compute.bin_margin_px)

    def optimize(self, surfels: S.Surfels, adam: S.AdamState,
                 kf: KeyframeBatch, kf_indices: torch.Tensor,
                 capture: bool | None = None):
        """The optimize loop -> (surfels, adam, loss EMA, iterations run).

        ``capture`` None: captured graphs on CUDA (``optimize_static``),
        the uncaptured ``run_block_loop`` on the CPU and, on CUDA too,
        under the debug checks, which read values back to the host (as
        ``jax_debug_nans`` runs a program without compiling it); True or
        False ask for one of the two."""
        if capture is None:
            capture = self.captures_on(surfels.active.device)
        if capture:
            return self.optimize_static(surfels, adam, kf, kf_indices,
                                        capture=True)
        return run_block_loop(
            surfels, adam, kf_indices,
            num_iters=self.n_iters(), rebin=self.rebin, early=self.early,
            patience_blocks=self.patience_blocks,
            es_threshold=self.es_threshold,
            make_tiles=lambda s, i: self.make_tiles(s, kf, i),
            one_iter=lambda s, a, i, t: self.one_iter(s, a, kf, i, t))

    def captures_on(self, device: torch.device) -> bool:
        """Whether ``optimize`` captures by default on ``device``: on
        CUDA, unless the debug checks are on (logged once)."""
        if device.type != "cuda":
            return False
        if debug.checks_active():
            if not self._said_uncaptured:
                logger.info("debug checks are on: the optimize blocks run "
                            "uncaptured, with the kernels")
                self._said_uncaptured = True
            return False
        return True

    def signature(self, kf_cap: int) -> tuple:
        """What one block graph is specialized to: (H, W, capacity,
        views, scatter, with_median, rebin, kf_cap)."""
        return (self.height, self.width, self.capacity, self.views,
                self.params.scatter, self.params.with_median, self.rebin,
                kf_cap)

    def optimize_static(self, surfels: S.Surfels, adam: S.AdamState,
                        kf: KeyframeBatch, kf_indices: torch.Tensor, *,
                        capture: bool):
        """``run_block_loop`` on a StaticBlock's buffers, the same blocks
        in the same order.  With ``capture`` (CUDA), each block is the
        signature's captured graph: the first update at a signature runs
        its block 0 uncaptured (the warm-up) and captures it after, and
        every later block, of this update and of later ones at the
        signature, replays.  Without, each block runs ``StaticBlock.body``
        directly.  Each step is a span under ``map.optimize``: ``load``,
        per block ``start_block`` (the stall check with early stopping)
        and ``body``, ``capture`` or ``replay``, then ``results``."""
        prof = get_profiler()
        sig = self.signature(kf.K.shape[0])
        static, prog = self._graphs.get(sig, (None, None))
        with prof.phase("map.optimize.load"):
            if static is None:
                if capture:
                    # the keyframe stack only grows within a submap: a
                    # graph at another stack size is not replayed again
                    self.release_graphs()
                static = StaticBlock(self, surfels, adam, kf, kf_indices[0])
            else:
                static.load(surfels, adam, kf)
        b = 0
        while b < self.n_blocks():
            with prof.phase("map.optimize.start_block"):
                if self.early and \
                        int(static.stalled) >= self.patience_blocks:
                    break
                static.start_block(kf_indices[b])
            if not capture:
                with prof.phase("map.optimize.body"):
                    static.body()
            else:
                if prog is None:
                    prog = graphs.CapturedProgram(
                        f"mapper block {sig}", static.body,
                        static.tensors(), span="map.optimize")
                    self._graphs[sig] = (static, prog)
                prog.run()
            b += 1
        with prof.phase("map.optimize.results"):
            return (*static.results(surfels.active), b * self.rebin)

    def graph_stats(self) -> dict:
        """{signature: the captured program's captures, replays and
        memory}."""
        return {sig: prog.stats() for sig, (_, prog) in self._graphs.items()}

    def release_graphs(self) -> None:
        """Drop the block graphs, their buffers and their pools."""
        for _, prog in self._graphs.values():
            prog.release()
        self._graphs.clear()

    def n_iters(self) -> int:
        return self.cfg.mapping.num_iterations + 1

    def n_blocks(self) -> int:
        return (self.n_iters() + self.rebin - 1) // self.rebin

    def prune(self, surfels: S.Surfels):
        return prune_core(surfels, mc=self.cfg.mapping)


class Mapper:
    """Orchestration around MapperPrograms.

    ``device``: None -> cuda (raises without a GPU).  ``seed`` seeds the
    generator of the Gumbel noise and the keyframe draws.

    With ``parallel.data * parallel.model`` > 1 this process is one rank
    of that many (torch.distributed, joined before, e.g. by torchrun and
    ``parallel.initialize_distributed``): densify, optimize and prune run
    through the sharded programs on a ("data", "model") mesh
    (parallel/sharded.py), each rank holding its "model" slice of the
    pool and of Adam during the update.  Between updates every rank holds
    the whole pool, gathered at the end of the update (the tracker and
    ``render_frame`` render it, as the JAX package replicates its sharded
    pool for them).  The draws come from rank 0, so every rank densifies
    and optimizes on the same ones.
    """

    def __init__(self, cfg: Configuration, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: LocalModel | None = None
        self._programs: dict[tuple, MapperPrograms] = {}
        self._sharded: dict[tuple, dict] = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.last_ema: torch.Tensor | None = None
        self.last_iters = 0
        # the last densify's sampled pixels [H, W] bool
        self._last_densify_mask: torch.Tensor | None = None
        self.mesh = None
        pc = cfg.parallel
        if pc.data * pc.model > 1:
            from ..parallel import make_mesh
            self.mesh = make_mesh(pc.data, pc.model, device=self.device)

    @property
    def writes(self) -> bool:
        """Whether this process writes logger output (rank 0 only)."""
        return self.mesh is None or self.mesh.rank == 0

    def register_model(self, model: LocalModel) -> None:
        """A new submap (or a restored one): the block graphs of the last
        one are freed."""
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, mapper on "
                             f"{self.device}")
        self.model = model
        self._release_graphs_below(None)

    def _release_graphs_below(self, capacity: int | None) -> None:
        """Free the block graphs of the programs whose capacity the pool
        has grown past (of every program when ``capacity`` is None)."""
        for (_, _, cap), progs in self._programs.items():
            if capacity is None or cap < capacity:
                progs.release_graphs()

    def graph_stats(self) -> dict:
        """{block graph signature: captures, replays, pool and static
        buffer bytes} over the programs still held."""
        out = {}
        for progs in self._programs.values():
            out.update(progs.graph_stats())
        return out

    def programs_for(self, height: int, width: int,
                     capacity: int) -> MapperPrograms:
        sig = (height, width, capacity)
        if sig not in self._programs:
            self._programs[sig] = MapperPrograms(self.cfg, *sig)
        return self._programs[sig]

    def _from_root(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank (unchanged without a mesh)."""
        if self.mesh is None:
            return t
        from ..parallel import collectives
        return collectives.broadcast_(t.contiguous(),
                                      self.mesh.group("world"))

    def _gumbel(self, n: int) -> torch.Tensor:
        u = torch.rand((n,), generator=self.generator, device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        return self._from_root(-torch.log(-torch.log(torch.clamp(u,
                                                                min=tiny))))

    def _draw_keyframes(self, probs: np.ndarray, n_blocks: int):
        """Per-block keyframe indices: [n_blocks], or [n_blocks, views]
        with views_per_iteration > 1 (drawn with replacement; the sharded
        programs render one view per iteration, as the JAX package's)."""
        views = max(1, int(self.cfg.mapping.views_per_iteration or 1))
        if self.mesh is not None:
            views = 1
        p = torch.as_tensor(probs, dtype=torch.float32, device=self.device)
        idx = self._from_root(torch.multinomial(
            p, n_blocks * views, replacement=True, generator=self.generator))
        return idx if views == 1 else idx.reshape(n_blocks, views)

    def _stack_keyframes(self, kf_cap: int) -> KeyframeBatch:
        """Keyframe batch from the model's incremental device-side stack."""
        model = self.model
        if model.kf_stack is None or \
                model.kf_stack["K"].shape[0] != kf_cap:
            model.rebuild_kf_stack()
        stack = model.kf_stack
        probs = sample_geometric_probs(
            len(model.keyframes), self.cfg.mapping.prob_view_last_keyframe,
            kf_cap)
        return KeyframeBatch(K=stack["K"], T_cw=stack["T_cw"],
                             depth=stack["depth"], valid=stack["valid"],
                             probs=probs)

    def partition(self, progs: MapperPrograms) -> str:
        """``parallel.partition`` with "auto" resolved: "tiles" on the cuda
        backend, "rows" on eager."""
        part = self.cfg.parallel.partition
        if part == "auto":
            from ..ops.rasterizer.api import _resolve_backend
            part = ("tiles" if _resolve_backend(progs.params.backend)
                    == "cuda" else "rows")
        return part

    def _sharded_programs(self, progs: MapperPrograms) -> dict:
        """The sharded densify/optimize/prune programs, once per program
        signature."""
        from ..parallel.sharded import (sharded_densify, sharded_optimize,
                                        sharded_optimize_ring,
                                        sharded_optimize_tiles,
                                        sharded_prune)
        builders = {"tiles": sharded_optimize_tiles,
                    "ring": sharded_optimize_ring,
                    "rows": sharded_optimize}
        part = self.partition(progs)
        if part not in builders:
            raise ValueError(f"unknown parallel.partition {part!r}; "
                             f"expected one of {sorted(builders)} or auto")
        sig = (progs.height, progs.width, progs.capacity)
        if sig not in self._sharded:
            mc, depth_ratio = self.cfg.mapping, self.cfg.opt.depth_ratio
            self._sharded[sig] = {
                "densify": sharded_densify(self.mesh, progs.params, mc,
                                           progs.max_new, depth_ratio),
                "optimize": builders[part](self.mesh, progs.params,
                                           progs.hyper, mc, self.cfg.compute,
                                           depth_ratio),
                "prune": sharded_prune(self.mesh, mc),
            }
        return self._sharded[sig]

    def render_frame(self, frame: Frame) -> dict:
        """Render the current model at a frame's camera (every rank holds
        the whole pool between updates)."""
        model = self.model
        cam = frame.camera_in_model()
        progs = self.programs_for(cam.height, cam.width, model.capacity)
        s = model.surfels
        with torch.no_grad():
            return render(s.params.xyz, s.scaling, s.rotation, s.opacity,
                          cam.T_cw, cam.K, progs.params,
                          depth_ratio=self.cfg.opt.depth_ratio)

    def update_model(self, frame: Frame, initialize_model: bool = False
                     ) -> None:
        """densify -> optimize -> prune."""
        model = self.model
        cam = frame.camera_in_model()
        h, w = cam.height, cam.width
        prof = get_profiler()
        progs = self.programs_for(h, w, model.capacity)
        model.ensure_free_slots(progs.max_new)
        if model.capacity != progs.capacity:
            progs = self.programs_for(h, w, model.capacity)
            self._release_graphs_below(model.capacity)
        sharded = (None if self.mesh is None
                   else self._sharded_programs(progs))
        surf, adam = model.surfels, model.adam
        if sharded is not None:
            from ..parallel.sharded import shard_model_state
            surf, adam = shard_model_state(self.mesh, surf, adam)
        densify = (progs.densify if sharded is None else
                   lambda s, a, c, g, initialize:
                   sharded["densify"][initialize](s, a, c, g))
        optimize = progs.optimize if sharded is None else sharded["optimize"]
        prune = progs.prune if sharded is None else sharded["prune"]

        with prof.phase("map.densify"):
            surf, adam, n_new, sampled = densify(
                surf, adam, cam, self._gumbel(h * w),
                initialize=initialize_model)
            with prof.phase("map.densify.read"):
                n_new = int(n_new)
        prof.count("map.densify.added", n_new)
        logger.info(f"Adding {n_new} new gaussians")
        self._last_densify_mask = sampled
        if self.cfg.logging.enable and self.writes:
            get_datalogger(self.cfg).log_image(
                "frame/densify_mask", sampled.cpu().numpy().astype(np.float32))

        # pad the keyframe count to a multiple of keyframe_capacity
        bucket = max(int(self.cfg.compute.keyframe_capacity), 1)
        kf_cap = ((len(model.keyframes) + bucket - 1) // bucket) * bucket
        with prof.phase("map.stack_kf"):
            kf = self._stack_keyframes(kf_cap)
        k11 = kernels.KERNELS["K11_image_loss"]
        k11_before = k11.launches
        with prof.phase("map.optimize"):
            with prof.phase("map.optimize.draw"):
                kf_indices = self._draw_keyframes(kf.probs,
                                                  progs.n_blocks())
            surf, adam, ema, n_iters = optimize(surf, adam, kf, kf_indices)
            with prof.phase("map.optimize.drain"):
                ema_value = float(ema)   # waits for the device
        # the update's image-loss launches, replays' included
        prof.count("kernel.K11_image_loss", k11.launches - k11_before)
        logger.debug(f"optimize done after {n_iters} iters, "
                     f"loss_ema={ema_value:.4f}")

        with prof.phase("map.prune"):
            surf, n_pruned = prune(surf)
            n_pruned = int(n_pruned)
        prof.count("map.prune.removed", n_pruned)
        if sharded is not None:
            from ..parallel.sharded import gather_model_state
            surf, adam = gather_model_state(self.mesh, surf, adam)
        model.surfels, model.adam = surf, adam
        logger.info(f"Pruning {n_pruned} gaussians")
        self.last_ema = ema
        self.last_iters = n_iters
        logger.info(f"Model updated. | No. primitives = "
                    f"{model.no_gaussians}, {model.size_mb:.2f} MB")
