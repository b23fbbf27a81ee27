"""gn_align_ms: the program's ``track.align`` span (``AlignerGN.align``:
the guess's upload, the captured Gauss-Newton loop's replay and the one
read of T and the fitness), mean over the tracked frames of the window
outside the profiled sub-window."""
import program_spans


def read(run):
    return program_spans.mean_ms(run, "track.align")
