"""track_ms: the program's ``track`` span (``Tracker.track``: the
source's set-up and the Gauss-Newton solve, ending in ``align``'s read of
T, so the device's solve is in it), mean over the tracked frames of the
window outside the profiled sub-window."""
import program_spans


def read(run):
    return program_spans.mean_ms(run, "track")
