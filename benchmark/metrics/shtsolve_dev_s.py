"""shtsolve_dev_s: the device extent of the program's SHTSOLVE span (CUDA
events at its edges, no sync), the analysis and the Poisson filter (sht/,
poisson.py), per traced plane of torch.profiler (benchmark/spans.py); none
off the card."""

from benchmark import spans


def read(run):
    return spans.device_s(run, ("SHTSOLVE",))
