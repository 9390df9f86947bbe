"""rayprop_s: the mean over the Profile'd planes of the Raytracer's RAYPROP phase:
the interpolation, transport and propagation (rays/), up to a device sync."""


def read(run):
    return run.phase_mean("RAYPROP")
