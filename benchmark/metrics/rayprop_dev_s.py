"""rayprop_dev_s: the device extent of the program's RAYPROP span (CUDA events
at its edges, no sync), the interpolation, transport and propagation
(rays/), per traced plane of torch.profiler (benchmark/spans.py); none off
the card."""

from benchmark import spans


def read(run):
    return spans.device_s(run, ("RAYPROP",))
