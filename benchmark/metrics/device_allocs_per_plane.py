"""device_allocs_per_plane: the program's device_alloc counter (the caching
allocator's cudaMallocs within the PLANE span), per traced plane
(benchmark/spans.py); none off the card."""

from benchmark import spans


def read(run):
    return spans.counter(run, "device_alloc")
