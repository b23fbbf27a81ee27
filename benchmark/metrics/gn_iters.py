"""gn_iters: the program's ``track.gn.iters`` counter (at each
Gauss-Newton solve, the iterations until the tolerance froze the pose,
or the configured number when it never did), mean over the solves of the
window's frames outside the profiled sub-window: how far the solve runs
from its cap.  None where the program has no such counter."""


def read(run):
    if not run.traced:
        return None
    from splatloam_tpu_torch import profiling
    prof = profiling.get_profiler()
    if not hasattr(prof, "counts"):
        return None
    frames = {f["index"] for f in run.untraced_frames}
    iters = [c.value for c in prof.counts()
             if c.name == "track.gn.iters" and c.frame in frames]
    return sum(iters) / len(iters) if iters else None
