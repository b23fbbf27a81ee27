"""slam_self_ms: SLAM.process's own time a frame: the benchmark's span
around the call less the program's ``track`` and ``map_update`` phases
in it, mean over the window's frames outside the profiled sub-window."""
import numpy as np


def read(run):
    frames = run.untraced_frames
    if not run.traced or not frames:
        return None
    return float(np.mean([
        f["process_ms"] - 1e3 * (f["phases"]["track"]
                                 + f["phases"]["map_update"])
        for f in frames]))
