"""sht_dev_s: the device extent of the program's SHT span (CUDA events at its
edges, no sync), the six-map synthesis (sht/), per traced plane of
torch.profiler (benchmark/spans.py); none off the card."""

from benchmark import spans


def read(run):
    return spans.device_s(run, ("SHT",))
