"""Mapper: densify -> optimize -> prune.

Counterpart of splatloam_tpu/slam/mapper.py:

  * densify: candidate mask from the rendered alpha + optional depth-error
    quantile; weighted sampling without replacement by Gumbel-top-k;
    back-projection; KNN scale init; normal-aligned rotations; writes
    into free surfel slots.
  * optimize: a Python loop over rebin blocks of Adam iterations, each
    block on one keyframe drawn from the geometric replay distribution (or
    ``mapping.views_per_iteration`` keyframes drawn with replacement,
    rendered in one batched pass and their losses averaged), with the
    paper's losses (Eq 15-17) and EMA early stopping.
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
from ..ops.rasterizer.api import (RenderParams, adaptive_geometry,
                                  fit_geometry, prepare_tiles,
                                  prepare_tiles_batch, render, render_batch)
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
        for _ in range(rebin):
            surfels, adam, loss = one_iter(surfels, adam, kf_idx, tiles)
            ema = torch.where(torch.isnan(ema), loss,
                              0.1 * loss + 0.9 * ema)
        improved = ema < best * (1.0 - es_threshold)
        best = torch.minimum(best, ema)
        stalled = torch.where(improved, 0, stalled + 1)
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


class MapperPrograms:
    """Mapping steps specialized to (H, W, capacity)."""

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

    def densify(self, surfels: S.Surfels, adam: S.AdamState,
                camera: Camera, gumbel: torch.Tensor, *, initialize: bool):
        pkg = None
        if not initialize:
            with torch.no_grad():
                pkg = render(surfels.params.xyz, surfels.scaling,
                             surfels.rotation, surfels.opacity, camera.T_cw,
                             camera.K, self.params, self.cfg.opt.depth_ratio)
        return densify_core(surfels, adam, camera, gumbel, pkg,
                            mc=self.cfg.mapping, max_new=self.max_new,
                            height=self.height, width=self.width)

    def _image_losses(self, pkg, gt_depth, valid):
        """Depth L1 + Eq 16 + Eq 15 of each view, over the last two (H, W)
        dims of the render package."""
        mc = self.cfg.mapping
        hw = (-2, -1)
        validf = valid.to(torch.float32)
        n_valid = torch.clamp(torch.sum(validf, dim=hw), min=1.0)
        # depth L1: mean over ALL pixels of |valid * (est - gt)|
        geom_l1 = torch.mean(torch.abs(validf * (pkg["surf_depth"]
                                                 - gt_depth)), dim=hw)
        # Eq 15: normal consistency on valid pixels
        ndot = torch.sum(pkg["rend_normal"] * pkg["surf_normal"], dim=-1)
        normal_loss = torch.sum((1.0 - ndot) * validf, dim=hw) / n_valid
        normal_loss = normal_loss * mc.opt_lambda_normal
        # Eq 16: BCE(alpha, valid) on valid pixels (targets are 1)
        a = torch.clamp(pkg["rend_alpha"], 1e-7, 1.0 - 1e-7)
        alpha_loss = torch.sum(-torch.log(a) * validf, dim=hw) / n_valid
        alpha_loss = alpha_loss * mc.opt_lambda_alpha
        return geom_l1 + alpha_loss + normal_loss

    def _scale_penalty(self, scaling, active):
        return scale_penalty(scaling, active, self.cfg.mapping)

    def _loss(self, params: S.SurfelParams, active, kf: KeyframeBatch,
              kf_idx, tiles=None):
        scaling = torch.exp(params.log_scale)
        opacity = torch.sigmoid(params.logit_opacity) * active
        pkg = render(params.xyz, scaling, params.quat, opacity,
                     kf.T_cw[kf_idx], kf.K[kf_idx], self.params,
                     self.cfg.opt.depth_ratio, tiles=tiles)
        return (self._image_losses(pkg, kf.depth[kf_idx], kf.valid[kf_idx])
                + self._scale_penalty(scaling, active))

    def _loss_multi(self, params: S.SurfelParams, active, kf: KeyframeBatch,
                    kf_idx, tiles=None):
        """views_per_iteration > 1: the mean of the per-view losses of the
        keyframes kf_idx [B], rendered through one batched pass."""
        scaling = torch.exp(params.log_scale)
        opacity = torch.sigmoid(params.logit_opacity) * active
        pkg = render_batch(params.xyz, scaling, params.quat, opacity,
                           kf.T_cw[kf_idx], kf.K[kf_idx], self.params,
                           self.cfg.opt.depth_ratio, tiles=tiles)
        return (torch.mean(self._image_losses(pkg, kf.depth[kf_idx],
                                              kf.valid[kf_idx]))
                + self._scale_penalty(scaling, active))

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

    def optimize(self, surfels: S.Surfels, adam: S.AdamState,
                 kf: KeyframeBatch, kf_indices: torch.Tensor):
        mc = self.cfg.mapping
        # amortized rebinning: a keyframe view + its tile lists are held
        # fixed for rebin_every consecutive Adam steps (exact when 1; the
        # binning radius carries a pixel margin to absorb parameter drift)
        rebin = max(1, int(self.cfg.compute.rebin_every))

        def make_tiles(surf, kf_idx):
            scaling = torch.exp(surf.params.log_scale)
            opacity = torch.sigmoid(surf.params.logit_opacity) * surf.active
            prep = prepare_tiles if self.views == 1 else prepare_tiles_batch
            return prep(surf.params.xyz, scaling, surf.params.quat, opacity,
                        kf.T_cw[kf_idx], kf.K[kf_idx], self.params,
                        margin_px=self.cfg.compute.bin_margin_px)

        return run_block_loop(
            surfels, adam, kf_indices,
            num_iters=self.n_iters(), rebin=rebin,
            early=bool(mc.early_stop_enable),
            patience_blocks=max(1, int((mc.early_stop_patience or 100)
                                       // rebin)),
            es_threshold=float(mc.early_stop_threshold or 0.01),
            make_tiles=make_tiles,
            one_iter=lambda s, a, i, t: self.one_iter(s, a, kf, i, t))

    def n_iters(self) -> int:
        return self.cfg.mapping.num_iterations + 1

    def n_blocks(self) -> int:
        rebin = max(1, int(self.cfg.compute.rebin_every))
        return (self.n_iters() + rebin - 1) // rebin

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
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, mapper on "
                             f"{self.device}")
        self.model = model

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
            n_new = int(n_new)
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
        with prof.phase("map.optimize"):
            kf_indices = self._draw_keyframes(kf.probs, progs.n_blocks())
            surf, adam, ema, n_iters = optimize(surf, adam, kf, kf_indices)
            ema_value = float(ema)   # waits for the device
        logger.debug(f"optimize done after {n_iters} iters, "
                     f"loss_ema={ema_value:.4f}")

        with prof.phase("map.prune"):
            surf, n_pruned = prune(surf)
            n_pruned = int(n_pruned)
        if sharded is not None:
            from ..parallel.sharded import gather_model_state
            surf, adam = gather_model_state(self.mesh, surf, adam)
        model.surfels, model.adam = surf, adam
        logger.info(f"Pruning {n_pruned} gaussians")
        self.last_ema = ema
        self.last_iters = n_iters
        logger.info(f"Model updated. | No. primitives = "
                    f"{model.no_gaussians}, {model.size_mb:.2f} MB")
