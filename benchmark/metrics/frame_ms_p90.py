"""frame_ms_p90: the 90th percentile of every frame's time in the
window (sweep handed over to SLAM.process returned and the device
synchronised)."""
import numpy as np


def read(run):
    if not run.frames:
        return None
    return float(np.percentile([f["ms"] for f in run.frames], 90))
