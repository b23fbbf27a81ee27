"""optimize_replay_ms: the program's ``map.optimize.replay`` span (the
host's ``graph.replay()`` call that launches one captured block of the
mapper's optimize loop), mean over the replays of the window's frames
outside the profiled sub-window.  None where no block was replayed (the
CPU runs the blocks uncaptured)."""
import program_spans


def read(run):
    return program_spans.mean_ms(run, "map.optimize.replay")
