"""driver_self_s: the host time in the program's PLANE span (Raytracer.step)
not covered by its phase spans or its closing SYNC, per traced plane of
torch.profiler (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.driver_self_s(run)
