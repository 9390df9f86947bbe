"""host_syncs_per_plane: the program's host_sync counter (the points of the
plane step where the host waits for the card), per traced plane
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.counter(run, "host_sync")
