"""sht_s: the mean over the Profile'd planes of the Raytracer's SHT phase:
the six-map synthesis (sht/), up to a device sync."""


def read(run):
    return run.phase_mean("SHT")
