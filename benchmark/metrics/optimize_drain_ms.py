"""optimize_drain_ms: the program's ``map.optimize.drain`` span (the
``float(ema)`` read after the last block is enqueued: how far the device
runs behind the host's launches), mean per keyframe update outside the
profiled sub-window."""
import program_spans


def read(run):
    return program_spans.mean_ms(run, "map.optimize.drain")
