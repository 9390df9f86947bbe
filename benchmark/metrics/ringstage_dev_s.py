"""ringstage_dev_s: the device extents of the program's RINGS spans (the
ring stages: the analysis's, the synthesis's pairs or streamed row blocks),
summed per traced plane of torch.profiler (benchmark/spans.py); none off
the card."""

from benchmark import spans


def read(run):
    return spans.device_s(run, ("RINGS",))
