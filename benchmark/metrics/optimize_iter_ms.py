"""optimize_iter_ms: the program's ``map.optimize`` phase (ends in
float(ema)) over the optimize iterations it ran (``mapper.last_iters``),
summed over the keyframe updates outside the profiled sub-window."""


def read(run):
    ups = [f for f in run.untraced_frames if f["updated"]]
    iters = sum(f["iters"] for f in ups)
    if not run.traced or iters == 0:
        return None
    return 1e3 * sum(f["phases"]["map.optimize"] for f in ups) / iters
