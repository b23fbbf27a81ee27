"""The comparison that decides ``correct``.

After the window closes, ``observe`` takes what the timed path produced
(the range images of a sample of the window's frames drawn from the
seed, the render that the window's newest keyframe update densified
from, the submaps' pools) and the program's state is freed.  ``compare``
then works out again, from the sweeps alone, what the program derived
from them, and sets each number beside its limit (``limits`` in
``workloads/<cell>.json``):

  range_mismatch   preprocessing: the largest share, over the sampled
                   frames, of pixels whose validity or depth differs
                   from the plain range image of the same sweep.
  render_mismatch  kernels: the share of the image's pixels where the
                   rasterizer's render that densify read (the pool
                   before the window's newest update, at its keyframe)
                   differs from the plain renderer's of the same pool:
                   alpha by more than ALPHA_TOL, or, where both cover
                   the pixel (alpha > 0.5), depth by more than DEPTH_TOL
                   of the plain depth.
  map_hole         mapper: the largest share, over a sample of the
                   keyframes the window inserted (drawn from the seed,
                   the newest among them), of the keyframe's measured
                   pixels that the plain renderer finds uncovered
                   (alpha <= 0.5) by the pool of the keyframe's submap.
  map_normal_deg   mapper, the optimizer: the largest, over the same
                   keyframes and over sectors of azimuth of 128 columns
                   (45 degrees at 1024), of the
                   median angle between the surfels' normal (the plain
                   renderer's, composited) and the measured surface's
                   (from neighbouring returns), over the covered pixels.
                   Densify sets a surfel facing the sensor; only the
                   optimizer turns it onto the surface, and it has to do
                   so in every direction the sensor sees.

With ``control`` the TF32 reference takes the program's place in the
two numbers it can stand in for (range_mismatch, render_mismatch): it
is the lower precision a later change might be tempted by, and it has to
fail.

A limit of ``workloads/<cell>.json`` that is none of BUILTIN is a check
that the cell brings: ``reference/checks/<name>.py`` (the harness loads
it; ``manifest.Manifest.check``).
"""
from __future__ import annotations

import numpy as np
import torch

from traffic.canyon import stream_seed
from . import range_image as ri
from . import raster

BUILTIN = ("range_mismatch", "render_mismatch", "map_hole",
           "map_normal_deg")
N_SAMPLED_FRAMES = 8
N_SAMPLED_KEYFRAMES = 6
ALPHA_TOL = 1e-4
DEPTH_TOL = 1e-5
SECTOR_COLUMNS = 128


def _index(frame, stream) -> int:
    return int(round(frame.timestamp / stream.dt))


def observe(prog, run, stream) -> dict:
    """Copies of what the window produced (the program's outputs)."""
    slam = prog.slam
    window = [f["index"] for f in run.frames]
    rng = np.random.default_rng(stream_seed(stream.seed, 4))
    picks = sorted(rng.choice(window, size=min(N_SAMPLED_FRAMES,
                                               len(window)), replace=False))
    kf = slam.local_models[-1].keyframes[-1]
    frames = {_index(f, stream): f for f in slam.frames}
    ranges = [(int(i), frames[i].camera.depth.cpu().numpy(),
               frames[i].camera.valid.cpu().numpy())
              for i in sorted(set(picks) | {_index(kf, stream)})]
    r = prog.last_render
    render = None
    if r is not None:
        render = dict(index=r["index"], pool=_pool(r["surfels"]),
                      alpha=r["alpha"].cpu().numpy(),
                      depth=r["depth"].cpu().numpy(),
                      T_cw=r["T_cw"].cpu().numpy(), K=r["K"].cpu().numpy())
    # keyframes the window inserted, each with its submap
    in_window = set(window)
    kfs = [(li, k) for li, m in enumerate(slam.local_models)
           for k in m.keyframes if _index(k, stream) in in_window]
    n = min(N_SAMPLED_KEYFRAMES - 1, max(len(kfs) - 1, 0))
    picks = rng.choice(len(kfs) - 1, size=n, replace=False) if n else []
    views = [kfs[j] for j in picks] + [(len(slam.local_models) - 1, kf)]
    pools = {li: _pool(slam.local_models[li].surfels) for li, _ in views}
    return dict(
        ranges=ranges, render=render,
        map_views=[dict(index=_index(k, stream), pool=li,
                        T_cw=np.linalg.inv(k.model_T_frame))
                   for li, k in views],
        pools=pools, window=window)


def _pool(s) -> dict:
    """A copy of a pool's active rows."""
    act = s.active
    return {k: getattr(s.params, k)[act].detach().clone()
            for k in ("xyz", "log_scale", "quat", "logit_opacity")}


def _render_args(pool: dict, T_cw, K) -> tuple:
    dev = pool["xyz"].device
    return (pool["xyz"], torch.exp(pool["log_scale"]), pool["quat"],
            torch.sigmoid(pool["logit_opacity"]),
            torch.as_tensor(T_cw, dtype=torch.float32, device=dev),
            torch.as_tensor(K, dtype=torch.float32, device=dev))


def render_mismatch(alpha, depth, ref_alpha, ref_depth) -> float:
    """The share of pixels where a render (alpha, depth) differs from the
    plain one (ref_alpha, ref_depth): alpha beyond ALPHA_TOL, or depth
    beyond DEPTH_TOL relative where both cover the pixel."""
    alpha, ref_alpha = alpha.astype(np.float64), ref_alpha.astype(np.float64)
    depth, ref_depth = depth.astype(np.float64), ref_depth.astype(np.float64)
    both = (alpha > 0.5) & (ref_alpha > 0.5) & (ref_depth > 0)
    gap = np.abs(depth - ref_depth) / np.where(both, ref_depth, 1.0)
    bad = (np.abs(alpha - ref_alpha) > ALPHA_TOL) | (both & (gap > DEPTH_TOL))
    return float(bad.mean())


def compare(obs: dict, stream, cfg, workload: dict,
            control: bool = False) -> list[dict]:
    pc = cfg.preprocessing
    h, w = int(pc.image_height), int(pc.image_width)
    dmin, dmax = float(pc.depth_min), float(pc.depth_max)
    limits = workload["limits"]
    out = []

    def add(name, value):
        out.append(dict(name=name, value=float(value),
                        limit=limits.get(name)))

    # preprocessing
    shares = []
    for i, depth, valid in obs["ranges"]:
        cloud = stream.sweep(i)
        rd, rv, _ = ri.range_image(cloud, h, w, dmin, dmax)
        if control:
            depth, valid, _ = ri.range_image(cloud, h, w, dmin, dmax,
                                             tf32=True)
        shares.append(ri.mismatch(depth, valid, rd, rv))
    add("range_mismatch", max(shares))

    # kernels: the render densify read, made in the window
    r = obs["render"]
    if r is None or r["index"] not in set(obs["window"]):
        add("render_mismatch", np.inf)
    else:
        args = _render_args(r["pool"], r["T_cw"], r["K"])
        ref = raster.render(*args, h, w)
        alpha, depth = r["alpha"], r["depth"]
        if control:
            low = raster.render(*args, h, w, tf32=True)
            alpha = low["alpha"].cpu().numpy()
            depth = low["depth"].cpu().numpy()
        add("render_mismatch", render_mismatch(
            alpha, depth, ref["alpha"].cpu().numpy(),
            ref["depth"].cpu().numpy()))
    if control:
        return out

    # mapper: the submaps at the window's keyframes
    holes, normals = [], []
    for v in obs["map_views"]:
        rd, rv, K, pts = ri.range_image(stream.sweep(v["index"]), h, w,
                                        dmin, dmax, points=True)
        out_v = raster.render(*_render_args(obs["pools"][v["pool"]],
                                            v["T_cw"], K), h, w,
                              normals=True)
        covered = out_v["alpha"].cpu().numpy() > 0.5
        holes.append(1.0 - covered[rv].mean() if rv.any() else np.inf)
        normals.append(normal_deg(out_v["normal"].cpu().numpy(), covered,
                                  *ri.surface_normals(pts, rv)))
    add("map_hole", max(holes))
    add("map_normal_deg", max(normals))
    return out


def normal_deg(normal, covered, surface, where) -> float:
    """The largest, over equal sectors of azimuth of SECTOR_COLUMNS
    columns (one for a narrower image), of the median angle (degrees)
    between the composited surfel normal and the measured surface's,
    over the covered pixels where the surface's normal is defined (a
    sector with none is passed over)."""
    n = np.asarray(normal, np.float64)
    norm = np.linalg.norm(n, axis=-1)
    ok = covered & where & (norm > 0)
    cos = np.abs(np.sum(n * surface, -1)) / np.where(norm > 0, norm, 1.0)
    deg = np.degrees(np.arccos(np.clip(cos, 0.0, 1.0)))
    sectors = max(1, n.shape[1] // SECTOR_COLUMNS)
    sector = np.arange(n.shape[1]) * sectors // n.shape[1]
    meds = [np.median(deg[ok & (sector == k)[None, :]])
            for k in range(sectors) if (ok & (sector == k)[None, :]).any()]
    return float(max(meds)) if meds else np.inf
