"""map_update_ms: the program's ``map_update`` phase (densify, optimize,
prune; ends in prune's count read back), mean per keyframe update
outside the profiled sub-window."""
import numpy as np


def read(run):
    t = [f["phases"]["map_update"] for f in run.untraced_frames
         if f["updated"]]
    if not run.traced or not t:
        return None
    return 1e3 * float(np.mean(t))
