"""Public rendering API: rasterize + channel decoding.

Counterpart of splatloam_tpu/ops/rasterizer/api.py.  ``render`` produces
rend_alpha / rend_normal (world frame, alpha-normalized) / rend_dist /
surf_depth / surf_normal (from depth finite differences) plus
radii/visibility from the raw rasterizer channels.

Backends: "cuda" = the kernel path (on CPU tensors its kernels run their
plain PyTorch versions), "eager" = the golden O(N*P) renderer, "auto" =
"cuda".  The tensors' device decides where the work runs.  ``render_batch``
renders B views of one surfel set, on the cuda backend through one launch
of each kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ... import debug
from ...geometry import se3, spherical
from .eager_ref import rasterize_eager


class RenderParams(NamedTuple):
    """Static rasterizer knobs."""
    height: int
    width: int
    backend: str = "auto"
    chunk: int = 256
    tile_h: int = 8
    tile_w: int = 32
    tile_list_capacity: int = 3072
    # the median/distortion channels cost extra work in the kernels; the
    # mapping losses use neither, so callers may disable them
    with_median: bool = True
    with_dist: bool = True
    # binner: "sorted" (capped windows, fast) or "exact" (unbounded
    # coverage; used by parity tests)
    binner: str = "sorted"
    cap_ty: int = 9
    cap_tx: int = 9
    # slot layout of the kernels: "tiled" = padded [T, K] per-tile lists,
    # "flat" = one compacted chunk-aligned slot pool (K7-K9 touch ~sum of
    # the counts slots instead of T*K; binning.build_flat_lists),
    # "bucketed" = two-capacity tile buckets (the top bucket_frac tiles by
    # count keep the full capacity, the rest truncate to bucket_k_small;
    # 0 = one chunk; single view)
    layout: str = "tiled"
    bucket_frac: float = 0.5
    bucket_k_small: int = 0
    # flat slot budget (a chunk multiple); 0 = T*K/2.  A scene whose
    # chunk-padded slots exceed it loses the tail tiles' deepest entries
    flat_capacity: int = 0
    # gradient reduction of the backward's per-slot rows:
    #   "rmw"     - atomic scatter-add kernel (K4);
    #   "ranksum" - rebin-time id-sort + segmented-sum kernel (K3), plus
    #               the overflow scatter (K6) when the plan is truncated
    #               (cuda_raster.RS_TRUNC);
    #   "plan"    - rebin-time occurrence tables: gather-sum of each
    #               surfel's first 4 rows + the overflow scatter (K6);
    #   "fused"   - the scatter-add folded into the backward kernel (K5).
    # All are exact up to float summation order.  Under "bucketed" only
    # "ranksum" keeps a plan; every other mode runs K5 per bucket.  The
    # flat layout has its own reduction (K9) and ignores ``scatter`` and
    # ``scatter_tps``.
    scatter: str = "rmw"
    # "rmw" only: tiles per CUDA block of the scatter-add (K10 when > 1;
    # reduced to a divisor of the tile count)
    scatter_tps: int = 1


def adaptive_geometry(n_surfels: int) -> dict:
    """Kernel geometry by pool size: small pools take bigger tiles (fewer
    mostly-empty tiles), 100k-scale pools 4x16 tiles.  The thresholds are
    the JAX package's, kept so both packages bin alike; they have not been
    re-swept for the H100."""
    if n_surfels <= 48_000:
        return dict(tile_h=8, tile_w=32, chunk=256, tile_list_capacity=1024)
    return dict(tile_h=4, tile_w=16, chunk=256, tile_list_capacity=768)


def fit_geometry(geo: dict, height: int, width: int) -> dict:
    """Shrink tile dims to divisors of the image (kernel precondition)."""
    geo = dict(geo)
    while height % geo["tile_h"]:
        geo["tile_h"] //= 2
    while width % geo["tile_w"]:
        geo["tile_w"] //= 2
    return geo


def _resolve_backend(backend: str) -> str:
    if backend == "auto":
        return "cuda"
    if backend not in ("cuda", "eager"):
        raise ValueError(f"unknown rasterizer backend {backend!r}")
    return backend


def rasterize(xyz, scaling, rotation, opacity, T_cw, K,
              params: RenderParams, tiles=None) -> dict:
    """Dispatch to a rasterizer backend; returns the raw channel dict.

    ``tiles``: optional frozen TileAssignment, FlatTiles or BucketedTiles
    (cuda backend only) to amortize binning across iterations; the eager path
    ignores it.
    """
    if _resolve_backend(params.backend) == "eager":
        return rasterize_eager(xyz, scaling, rotation, opacity, T_cw, K,
                               params.height, params.width, params.chunk)
    from .cuda_raster import rasterize_cuda
    return rasterize_cuda(xyz, scaling, rotation, opacity, T_cw, K, params,
                          tiles=tiles)


def prepare_tiles(xyz, scaling, rotation, opacity, T_cw, K,
                  params: RenderParams, margin_px: float = 0.0):
    """Precompute a frozen TileAssignment, or FlatTiles / BucketedTiles
    under ``layout="flat"`` / ``"bucketed"`` (None on the eager backend)."""
    if _resolve_backend(params.backend) != "cuda":
        return None
    from .cuda_raster import prepare_tiles as _prep
    return _prep(xyz, scaling, rotation, opacity, T_cw, K, params,
                 margin_px=margin_px)


def render(xyz, scaling, rotation, opacity, T_cw, K,
           params: RenderParams, depth_ratio: float = 0.0,
           tiles=None) -> dict:
    """Full render + decode.

    Args are *activated* surfel parameters (scaling positive, opacity in
    (0,1), rotation approx. unit quaternion) in the model frame, plus the
    model->camera transform T_cw and spherical intrinsics K, all on one
    device.

    Returns a dict: rend_alpha [H, W], rend_normal [H, W, 3] (world frame,
    alpha-normalized), rend_dist [H, W], surf_depth [H, W], surf_normal
    [H, W, 3] (x alpha), rend_median [H, W], radii [N],
    visibility_filter [N] bool.
    """
    chans = rasterize(xyz, scaling, rotation, opacity, T_cw, K, params,
                      tiles=tiles)
    pkg = _decode(chans, T_cw, K, depth_ratio)
    debug.check_outputs(pkg, "render")
    return pkg


def _decode(chans, T_cw, K, depth_ratio) -> dict:
    """Raw channels -> render package."""
    alpha = chans["alpha"]
    mask = alpha > 0.0
    safe_alpha = torch.where(mask, alpha, 1.0)

    R_wc = T_cw[:3, :3].T
    normal_cam = chans["normal_sum"] / safe_alpha[..., None]
    rend_normal = torch.where(mask[..., None], normal_cam @ R_wc.T, 0.0)

    depth_expected = torch.where(mask, chans["depth_sum"] / safe_alpha, 0.0)
    surf_depth = depth_expected * (1.0 - depth_ratio) + \
        chans["median"] * depth_ratio

    T_wc = se3.invert_T(T_cw)
    surf_normal = spherical.depth_to_normal(surf_depth, K, T_wc)
    surf_normal = surf_normal * alpha[..., None]

    return {
        "rend_alpha": alpha,
        "rend_normal": rend_normal,
        "rend_dist": chans["dist"],
        "rend_median": chans["median"],
        "surf_depth": surf_depth,
        "surf_normal": surf_normal,
        "radii": chans["radii"],
        "visibility_filter": chans["radii"] > 0,
    }


def render_batch(xyz, scaling, rotation, opacity, T_cw, K,
                 params: RenderParams, depth_ratio: float = 0.0,
                 tiles=None) -> dict:
    """Multi-view render over one surfel set: T_cw [B, 4, 4], K [B, 3, 3]
    -> the render package with a leading [B] axis on every entry.  The
    cuda backend runs all B views through one launch of each kernel
    (``tiles`` from prepare_tiles_batch reuses a frozen binning); the eager
    renderer loops over the views."""
    if _resolve_backend(params.backend) == "cuda":
        from .cuda_raster import rasterize_cuda_batched
        chans = rasterize_cuda_batched(xyz, scaling, rotation, opacity, T_cw,
                                       K, params, tiles=tiles)
    else:
        views = [rasterize_eager(xyz, scaling, rotation, opacity, T_cw[v],
                                 K[v], params.height, params.width,
                                 params.chunk)
                 for v in range(T_cw.shape[0])]
        chans = {k: torch.stack([c[k] for c in views]) for k in views[0]}
    pkgs = [_decode({k: c[v] for k, c in chans.items()}, T_cw[v], K[v],
                    depth_ratio) for v in range(T_cw.shape[0])]
    pkg = {k: torch.stack([p[k] for p in pkgs]) for k in pkgs[0]}
    debug.check_outputs(pkg, "render_batch")
    return pkg


def prepare_tiles_batch(xyz, scaling, rotation, opacity, T_cw, K,
                        params: RenderParams, margin_px: float = 0.0):
    """Frozen per-view binning states stacked on [B] (None on the eager
    backend)."""
    if _resolve_backend(params.backend) != "cuda":
        return None
    from .cuda_raster import prepare_tiles_batched
    return prepare_tiles_batched(xyz, scaling, rotation, opacity, T_cw, K,
                                 params, margin_px=margin_px)
