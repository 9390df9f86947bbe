"""deposit_s: the mean over the Profile'd planes of the Raytracer's DEPOSIT phase:
deposit (ops/deposit), up to a device sync."""


def read(run):
    return run.phase_mean("DEPOSIT")
