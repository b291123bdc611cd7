"""frames_per_s: every frame completed in the window over the window's
seconds (its start to the last request's completion). Host clock."""


def read(run):
    if run.requests == 0 or run.window_s <= 0:
        return None
    return run.frames / run.window_s
