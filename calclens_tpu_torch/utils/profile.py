"""Per-phase timers of the Profile mode (reference profile.c's totals).

The part of calclens_tpu/utils/profile.py that the port's driver uses: the
totals and counts per tag and the per-task `timing` file, filled from
intervals the caller measures.  The analog of per-phase MPI wall times is
host wall-clock around device synchronisation points: torch.cuda.synchronize
on the device of a CUDA tensor, nothing for a CPU tensor (its work is done
when the call returns).
"""

from __future__ import annotations

import torch


def sync(t):
    """Wait for the device work behind tensor t (or the tensors of a tuple
    or list): torch.cuda.synchronize on its device when it lives on a GPU,
    nothing on the CPU or for other values."""
    if isinstance(t, (tuple, list)):
        for x in t:
            sync(x)
    elif isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Profiler:
    def __init__(self):
        self.total = {}
        self.count = {}

    def add(self, tag, dt):
        """Accumulate one measured interval of dt seconds under tag."""
        self.total[tag] = self.total.get(tag, 0.0) + dt
        self.count[tag] = self.count.get(tag, 0) + 1

    def report(self):
        width = max((len(t) for t in self.total), default=8)
        lines = [f"{t:<{width}} {self.total[t]:12.6f}s  x{self.count[t]}"
                 for t in sorted(self.total, key=self.total.get, reverse=True)]
        return "\n".join(lines)

    def write(self, path):
        """Per-task `timing` file (reference printProfileInfo)."""
        with open(path, "w") as fp:
            fp.write(self.report() + "\n")
