"""Measurement tools of the port, for the card:

    python -m calclens_tpu_torch.tools.roofline_legendre [--order 12]
    python -m calclens_tpu_torch.tools.exp_gather
    python -m calclens_tpu_torch.tools.legendre_variants [--order 12]
    python -m calclens_tpu_torch.tools.bench_gals [--device cpu]

`roofline_legendre` measures the ceilings of the Legendre sweep (P1) and
each Legendre kernel's share of them; `exp_gather` measures gathers from a
table held on chip (P2-P4) beside torch's own `tab[idx]`;
`legendre_variants` times design variants of K1-K4 built from edited
copies of their sources; `bench_gals` times the galaxy image search.  All
need a CUDA device: a measurement that finds none fails (`bench_gals
--device cpu` runs on the CPU, for tests).  Nothing is compiled or
launched when these modules are imported.
"""

from __future__ import annotations

import contextlib
import re
import shutil
import subprocess

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


def sass() -> str:
    """cuobjdump -sass of the built kernel library (built if need be)."""
    from .. import _ext

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", _ext.build()], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_functions(text: str):
    """[(mangled name, body)] of every function in a cuobjdump -sass
    listing, in its order."""
    return [(body.split("\n", 1)[0].strip(), body)
            for body in re.split(r"\n\s*Function : ", text)[1:]]


def sass_instructions(body: str):
    """[(address, opcode, predicated, branch target or None)] of the SASS
    instructions in `body`; the opcode with its modifiers (e.g. "STS.128",
    "HGMMA.64")."""
    out = []
    for line in body.split("\n"):
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9._]*)([^;]*);", line)
        if m:
            t = re.search(r"0x([0-9a-f]+)\s*$", m.group(4))
            tgt = (int(t.group(1), 16) if m.group(3).startswith("BRA") and t
                   else None)
            out.append((int(m.group(1), 16), m.group(3), bool(m.group(2)),
                        tgt))
    return out
