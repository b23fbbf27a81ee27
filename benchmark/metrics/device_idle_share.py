"""device_idle_share: the share of the profiled sub-window (the window's
first frames, through ``trace_updates`` keyframe updates) in which no
operation ran on the device (torch.profiler, CUPTI)."""
import tracing


def read(run):
    if not run.traced or not run.device_events:
        return None
    busy, window = tracing.busy_and_window(run)
    if window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
