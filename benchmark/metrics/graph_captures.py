"""graph_captures: the program's ``graph.captures`` counter (a CUDA graph
captured by ``graphs.CapturedProgram``: a new signature's first optimize
block, after a submap rollover or a pool's growth), summed over the
window's frames outside the profiled sub-window."""
import program_spans


def read(run):
    return program_spans.total(run, "graph.captures")
