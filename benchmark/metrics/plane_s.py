"""plane_s: the timed window's wall time over the whole planes it stepped."""


def read(run):
    if not run.planes or run.window_s is None:
        return None
    return run.window_s / run.planes
