"""setup_s: from the process's start to the window's: CUDA's start, the
kernels' load (their build, in a checkout's first run), the first sweeps
and the frames through the first keyframe updates, whose graphs are
captured there."""


def read(run):
    return run.setup_s
