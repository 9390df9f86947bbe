"""deposit_dev_s: the device extent of the program's DEPOSIT span (CUDA events
at its edges, no sync), the deposit (ops/deposit), per traced plane of
torch.profiler (benchmark/spans.py); none off the card."""

from benchmark import spans


def read(run):
    return spans.device_s(run, ("DEPOSIT",))
