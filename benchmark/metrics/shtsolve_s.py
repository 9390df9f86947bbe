"""shtsolve_s: the mean over the Profile'd planes of the Raytracer's SHTSOLVE phase:
the analysis and the Poisson filter (sht/, poisson.py), up to a device sync."""


def read(run):
    return run.phase_mean("SHTSOLVE")
