"""frames_per_s: every frame the window completed over the window's
whole time (the sum of the frames' times)."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    return len(run.frames) / run.window_s
