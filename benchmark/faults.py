"""Faults planted in the timed path, for the check that the comparison
fails them (``run.py --fault <name>``; never in a measured run).  Each is
planted once set-up has ended and breaks the window's frames; none
outlives its run's program.

  map_frozen       the mapper's keyframe update returns its state
                   unchanged (the submap's first update still runs)
  optimize_frozen  the optimize loop returns the pool it was given;
                   densify and prune still run
  half_batch       each optimize iteration's loss is taken over the left
                   half of the view's pixels, its means over that half
  half_sweep       Preprocessor gets every other point of each sweep
  depth_altered    each frame's range image altered where it is made
  render_altered   the depth of the render that densify reads altered
                   where the rasterizer hands it over
"""
from __future__ import annotations

import torch

NAMES = ("map_frozen", "optimize_frozen", "half_batch", "half_sweep",
         "depth_altered", "render_altered")


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


def _half_batch(progs) -> None:
    losses = progs._image_losses

    def half(pkg, gt_depth, valid):
        axis, keep = gt_depth.ndim - 1, gt_depth.shape[-1] // 2

        def cut(t):
            return t.narrow(axis, 0, keep)
        pkg = {k: cut(v) if torch.is_tensor(v) and
               v.shape[:axis + 1] == gt_depth.shape else v
               for k, v in pkg.items()}
        return losses(pkg, cut(gt_depth), cut(valid))
    progs._image_losses = half
    # the block graphs captured in set-up hold the whole loss
    progs.release_graphs()


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
        _on_programs(slam.mapper, _half_batch)
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
    else:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
