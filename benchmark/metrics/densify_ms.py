"""densify_ms: the program's ``map.densify`` phase (the render densify
reads, ``densify_core``, and the ``int(n_new)`` read it ends in), mean
per keyframe update outside the profiled sub-window."""
import program_spans


def read(run):
    return program_spans.mean_ms(run, "map.densify")
