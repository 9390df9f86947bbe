"""Measurement tools of the port, for the card:

    python -m calclens_tpu_torch.tools.roofline_legendre [--order 12]
    python -m calclens_tpu_torch.tools.exp_gather

`roofline_legendre` measures the ceilings of the Legendre sweep (P1) and
each Legendre kernel's share of them; `exp_gather` measures gathers from a
table held on chip (P2-P4) beside torch's own `tab[idx]`.  Both need a
CUDA device: a measurement that finds none fails.  Nothing is compiled or
launched when these modules are imported.
"""

from __future__ import annotations

import contextlib

import torch


def require_cuda(device) -> torch.device:
    """The CUDA device to measure on; raises when there is none."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the measurement needs a CUDA device, got {dev} "
                           f"(torch sees a GPU: {torch.cuda.is_available()})")
    return dev


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream: CUDA events
    around `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products inside the block (TF32 off), restored
    after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
