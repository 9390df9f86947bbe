"""driver_idle_s: the rest of the traced window's device idle time: gaps
that start while the host is in the program's PLANE span outside its
phases, in its SYNC, or between planes, per traced plane
(benchmark/spans.py); none off the card."""

from benchmark import spans


def read(run):
    split = spans.idle_split(run)
    return None if split is None else split[1]
