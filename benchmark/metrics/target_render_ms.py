"""target_render_ms: the program's ``track.target`` span
(``AlignerGN.set_target``: the model rendered at a new keyframe's view,
the registration target derived from it, closed by a synchronize), mean
over the keyframes of the window outside the profiled sub-window.  None
where the program has no such span."""
import program_spans


def read(run):
    return program_spans.mean_ms(run, "track.target")
