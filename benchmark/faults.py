"""Faults planted in the timed path, for the check that the comparison
fails them (``run.py --fault <name>``; never in a measured run).  Each is
planted once set-up has ended and breaks the window's frames; none
outlives its run's program.

  map_frozen       the mapper's keyframe update returns its state
                   unchanged (the submap's first update still runs)
  optimize_frozen  the optimize loop returns the pool it was given;
                   densify and prune still run
  half_batch       the optimize iterations see the left half of each
                   keyframe: the stacked keyframes' depth and valid
                   masks, which K11 reads, cut to it (the right half
                   invalid), so that the alpha and normal losses are
                   means over the left half (the depth L1, a mean over
                   all pixels by the loss's definition, counts it alone)
  half_sweep       Preprocessor gets every other point of each sweep
  depth_altered    each frame's range image altered where it is made
  render_altered   the depth of the render that densify reads altered
                   where the rasterizer hands it over
  track_frozen     the tracker's aligner returns its guess
  track_short      the tracker's Gauss-Newton loop stops after 2
                   iterations
"""
from __future__ import annotations

import numpy as np

NAMES = ("map_frozen", "optimize_frozen", "half_batch", "half_sweep",
         "depth_altered", "render_altered", "track_frozen", "track_short")
SHORT_ITERATIONS = 2


def _on_programs(mapper, change) -> None:
    """``change`` on each of the mapper's programs, those it makes later
    (a grown pool's) included."""
    for progs in mapper._programs.values():
        change(progs)
    made = mapper.programs_for

    def programs_for(height, width, capacity):
        new = (height, width, capacity) not in mapper._programs
        progs = made(height, width, capacity)
        if new:
            change(progs)
        return progs
    mapper.programs_for = programs_for


def _optimize_frozen(progs) -> None:
    def unchanged(surfels, adam, kf, kf_indices, capture=None):
        return surfels, adam, surfels.params.xyz.new_zeros(()), \
            progs.n_iters()
    progs.optimize = unchanged


def _half_batch(mapper) -> None:
    stack = mapper._stack_keyframes

    def left_half(kf_cap):
        kf = stack(kf_cap)
        keep = kf.depth.shape[-1] // 2
        depth, valid = kf.depth.clone(), kf.valid.clone()
        depth[..., keep:] = 0.0
        valid[..., keep:] = False
        return kf._replace(depth=depth, valid=valid)
    mapper._stack_keyframes = left_half


def plant(name: str, prog) -> None:
    slam = prog.slam
    if name == "map_frozen":
        update = slam.mapper.update_model

        def frozen(frame, initialize_model=False):
            if initialize_model:
                update(frame, initialize_model=True)
        slam.mapper.update_model = frozen
    elif name == "optimize_frozen":
        _on_programs(slam.mapper, _optimize_frozen)
    elif name == "half_batch":
        _half_batch(slam.mapper)
    elif name in ("half_sweep", "depth_altered"):
        pre = prog.pre

        def altered(cloud, timestamp, gt_pose=None):
            if name == "half_sweep":
                cloud = cloud[::2]
            frame = pre(cloud, timestamp, gt_pose=gt_pose)
            if name == "depth_altered":
                frame.camera.depth.mul_(1.01)
            return frame
        prog.pre = altered
    elif name == "render_altered":
        keep = prog.densify_render

        def altered_render(surfels, camera, pkg):
            pkg = dict(pkg, surf_depth=pkg["surf_depth"] * 1.001)
            return keep(surfels, camera, pkg)
        prog.densify_render = altered_render
    elif name == "track_frozen":
        slam.tracker.aligner.align = lambda iguess: \
            np.array(iguess, np.float64)
    elif name == "track_short":
        aligner = slam.tracker.aligner
        settings = aligner.solver_settings
        aligner.solver_settings = lambda: dict(
            settings(), num_iterations=SHORT_ITERATIONS)
    else:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
