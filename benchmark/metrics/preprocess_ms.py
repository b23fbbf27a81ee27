"""preprocess_ms: Preprocessor's time a frame, the benchmark's own span
around the call closed by a synchronize (traced runs), mean over the
window's frames outside the profiled sub-window."""
import numpy as np


def read(run):
    frames = run.untraced_frames
    if not run.traced or not frames:
        return None
    return float(np.mean([f["pre_ms"] for f in frames]))
