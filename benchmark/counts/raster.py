"""Operations and bytes of the rasterizer's forward (K1) and backward
(K2) for one view, from the pool and the view alone.

Pairs are counted by the plain reference (reference/raster.py): the
(pixel, surfel) pairs that 2DGS compositing needs, in depth order, with
alpha > 0 while the transmittance before the surfel is above T_EPS.
Nothing is read from the port's tile lists, plans or launch arguments.

Operations per pair, frozen from chip_smoke.py (FWD_OPS_PER_PAIR,
BWD_OPS_PER_PAIR), counted from the kernels' arithmetic: the splat
geometry (~35) plus compositing (~25) in the forward; the geometry once
plus the gradient algebra (~80) and the 16-row sum over pixels in the
backward.

Bytes: each input read once and each output written once.  The forward
reads the surfels' 16 float32 features, each pixel's ray and coordinates
(5 floats) and writes 8 float32 channels a pixel; the backward reads the
features, the rays and coordinates, the forward's 8 channels and their 8
cotangents, and writes 16 float32 feature gradients a surfel.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import raster

FWD_OPS_PER_PAIR = 60
BWD_OPS_PER_PAIR = 131
FEATURE_BYTES = 16 * 4
PIXEL_IN_BYTES = 5 * 4
CHANNEL_BYTES = 8 * 4


def view_weights(n: int, last_kf_prob) -> np.ndarray:
    """The mapper's replay distribution over a submap's n keyframes in
    insertion order, as the configuration's ``prob_view_last_keyframe``
    states it: keyframe i (1 the oldest, n the newest) proportional to
    (1 - p)^(n - i) p, so the newest weighs p and each older one 1 - p
    times the next; uniform when p is unset or negative, all on the one
    keyframe when n is 1."""
    if n == 1:
        return np.ones(1)
    if last_kf_prob is None or last_kf_prob < 0:
        return np.full(n, 1.0 / n)
    age = np.arange(n - 1, -1, -1, dtype=np.float64)
    p = (1.0 - last_kf_prob) ** age * last_kf_prob
    return p / p.sum()


def pairs(xyz, scaling, quat, opacity, T_cw, K, height, width) -> int:
    out = raster.render(xyz, scaling, quat, opacity, T_cw, K, height, width,
                        count_pairs=True)
    return int(out["pairs"].sum())


def fwd_bytes(n_surfels: int, n_pixels: int) -> int:
    return (n_surfels * FEATURE_BYTES
            + n_pixels * (PIXEL_IN_BYTES + CHANNEL_BYTES))


def bwd_bytes(n_surfels: int, n_pixels: int) -> int:
    return (2 * n_surfels * FEATURE_BYTES
            + n_pixels * (PIXEL_IN_BYTES + 2 * CHANNEL_BYTES))


def expected_per_launch(updates: list[dict], last_kf_prob,
                        max_views: int = 4, seed: int = 0) -> dict:
    """Pairs, surfels and pixels of one optimize iteration, averaged over
    the updates (weighted by their iterations) and over each update's
    views (weighted by the replay distribution; with more than
    ``max_views`` keyframes, ``max_views`` of them drawn from it stand
    for the rest)."""
    rng = np.random.default_rng(seed)
    tot_iters = tot_pairs = tot_surfels = 0.0
    n_pixels = 0
    for u in updates:
        n = len(u["views"])
        wts = view_weights(n, last_kf_prob)
        if n <= max_views:
            picks, pw = np.arange(n), wts
        else:
            picks = rng.choice(n, size=max_views, p=wts)
            pw = np.full(max_views, 1.0 / max_views)
        e_pairs = sum(w * pairs(u["xyz"], u["scaling"], u["quat"],
                                u["opacity"], u["views"][k], u["K"][k],
                                u["height"], u["width"])
                      for k, w in zip(picks, pw))
        it = max(u["iters"], 1)
        tot_iters += it
        tot_pairs += it * e_pairs
        tot_surfels += it * len(u["xyz"])
        n_pixels = u["height"] * u["width"]
    if tot_iters == 0:
        return {}
    return dict(pairs=tot_pairs / tot_iters,
                surfels=tot_surfels / tot_iters, pixels=n_pixels)


def per_launch(run) -> dict:
    """expected_per_launch of a run's traced updates, counted once."""
    if not hasattr(run, "_raster_counts"):
        run._raster_counts = expected_per_launch(
            run.updates, run.cfg.mapping.prob_view_last_keyframe)
    return run._raster_counts
