"""Gathers from a table held on chip (P2-P4), beside torch's `tab[idx]`.

    python -m calclens_tpu_torch.tools.exp_gather [--device cuda]

Counterpart of tools/exp_pallas_gather.py, at its shapes: N = 2^23
indices into a table of W = 4096 rows of F = 8 float32 fields, all from a
seeded numpy generator.  Three kernels of csrc/gather_probe.cu compute the
same out = tab[idx]:
  gather_rows    [W, F] table -> [N, F]   (TPU pallas_a);
  gather_lanes   [F, W] table -> [F, N]   (TPU pallas_a2);
  gather_onehot  [W, F] table -> [N, F] by the two-level one-hot product on
                 the tensor cores (TPU pallas_b): it tells the ray side what
                 a one-hot product costs on this card.
Each is held bit for bit against torch's `tab[idx]` (`tabT[:, idx]`) and
timed beside it.  The access pattern is that of the ray side's taps
(rays/soa.py).  The last line printed is a JSON object of every number.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import cuda_ms, no_tf32, require_cuda

N = 1 << 23   # indices per call (8.4M)
W = 4096      # table rows
F = 8         # fields per row
SEG = 128     # lanes per segment of the one-hot route
HBM_RATE = 3.35e12  # bytes/s, NVIDIA's H100 SXM data sheet
BF16_PEAK = 989e12  # dense BF16 FLOP/s on the tensor cores, the same sheet
# gather_onehot computes every lane of every row, as the TPU kernel does:
# 3 bf16 parts x 2 x 128 m16n8k16 products (2 * 16 * 8 * 16 FLOPs each) per
# 16 indices
ONEHOT_FLOPS_PER_INDEX = 3 * 2 * 128 * (2 * 16 * 8 * 16) / 16
REPS = 20


def inputs(n=N, seed=0, device="cpu"):
    """(tab [W, F] float32 standard normal, idx [n] int32 uniform in
    [0, W)) from numpy's generator `seed`, on `device`."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((W, F), dtype=np.float32)
    idx = rng.integers(0, W, size=n, dtype=np.int32)
    return torch.tensor(tab, device=device), torch.tensor(idx, device=device)


def gather_rows_plain(tab, idx):
    return tab[idx]


def gather_lanes_plain(tabT, idx):
    return tabT[:, idx]


def bf16_parts(tab):
    """tab = hi + mid + lo exactly: each part is the bf16 nearest to what
    the parts before it leave over."""
    hi = tab.to(torch.bfloat16)
    r1 = tab - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def gather_onehot_plain(tab, idx, chunk=1 << 16):
    """gather_onehot's route in plain PyTorch: per part, the one-hot rows
    (idx // 128 == s) times the table as [W / 128, 128 F], then the lane
    idx % 128 of each row; the parts summed as (hi + mid) + lo."""
    nseg = W // SEG
    parts = [p.float().reshape(nseg, SEG * F) for p in bf16_parts(tab)]
    segs = torch.arange(nseg, device=tab.device)
    out = torch.empty((len(idx), F), dtype=torch.float32, device=tab.device)
    with no_tf32():
        for c0 in range(0, len(idx), chunk):
            ix = idx[c0: c0 + chunk].long()
            onehot = (ix[:, None] // SEG == segs[None, :]).float()
            rows = torch.arange(len(ix), device=tab.device)
            sel = [(onehot @ p).view(-1, SEG, F)[rows, ix % SEG]
                   for p in parts]
            out[c0: c0 + chunk] = (sel[0] + sel[1]) + sel[2]
    return out


def _check(name, tab, idx, tab_shape):
    if tab.device.type != "cuda" or idx.device != tab.device:
        raise ValueError(f"{name}: tab on {tab.device}, idx on {idx.device}; "
                         f"both must be on one CUDA device")
    if tab.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"{name}: takes a float32 table and int32 indices, "
                        f"got {tab.dtype} and {idx.dtype}")
    if tuple(tab.shape) != tab_shape or idx.dim() != 1:
        raise ValueError(f"{name}: table {tuple(tab.shape)} (expected "
                         f"{tab_shape}), indices of shape {tuple(idx.shape)}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if tab.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be 16-byte aligned")


def gather_rows_cuda(tab, idx):
    from ..sht.legendre import _launch

    _check("gather_rows", tab, idx, (W, F))
    out = torch.empty((len(idx), F), dtype=torch.float32, device=tab.device)
    _launch("gather_rows", "gather_rows_launch", tab.device, tab.data_ptr(),
            idx.data_ptr(), out.data_ptr(), len(idx))
    return out


def gather_lanes_cuda(tabT, idx):
    from ..sht.legendre import _launch

    _check("gather_lanes", tabT, idx, (F, W))
    out = torch.empty((F, len(idx)), dtype=torch.float32, device=tabT.device)
    _launch("gather_lanes", "gather_lanes_launch", tabT.device,
            tabT.data_ptr(), idx.data_ptr(), out.data_ptr(), len(idx))
    return out


def gather_onehot_cuda(tab, idx):
    from ..sht.legendre import _launch

    _check("gather_onehot", tab, idx, (W, F))
    out = torch.empty((len(idx), F), dtype=torch.float32, device=tab.device)
    _launch("gather_onehot", "gather_onehot_launch", tab.device,
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), len(idx))
    return out


def gather_rows(tab, idx):
    """P2 wrapper: tab [4096, F], idx [N] -> [N, F]; the kernel for CUDA
    tensors, the plain version for CPU ones."""
    if tab.device.type == "cpu":
        return gather_rows_plain(tab, idx)
    return gather_rows_cuda(tab, idx)


def gather_lanes(tabT, idx):
    """P3 wrapper: tabT [F, 4096], idx [N] -> [F, N]."""
    if tabT.device.type == "cpu":
        return gather_lanes_plain(tabT, idx)
    return gather_lanes_cuda(tabT, idx)


def gather_onehot(tab, idx):
    """P4 wrapper: tab [4096, F], idx [N] -> [N, F] by the one-hot route."""
    if tab.device.type == "cpu":
        return gather_onehot_plain(tab, idx)
    return gather_onehot_cuda(tab, idx)


def bound_ms(name, n=N):
    """(least time in ms, what bounds it) for kernel `name` on n indices:
    the larger of the bytes of out = tab[idx] (index, table and output
    moved once) over the card's memory rate and, for gather_onehot, its
    tensor-core products over the BF16 peak."""
    t = {"bytes": 4.0 * (n + W * F + n * F) / HBM_RATE,
         "operations": (n * ONEHOT_FLOPS_PER_INDEX / BF16_PEAK
                        if name == "gather_onehot" else 0.0)}
    by = max(t, key=t.get)
    return 1e3 * t[by], by


def run(device="cuda"):
    """Every kernel against torch's gather on the same inputs (bit for bit)
    and timed beside it (CUDA events, mean of REPS after a warm-up; the
    plain versions REPS / 10): name -> dict(ms, plain_ms, library_ms,
    bound_ms, bound_by, exact, max_abs_err)."""
    dev = require_cuda(device)
    tab, idx = inputs(device=dev)
    tabT = tab.T.contiguous()
    cases = {
        "gather_rows": (lambda: gather_rows_cuda(tab, idx),
                        lambda: gather_rows_plain(tab, idx),
                        lambda: tab[idx]),
        "gather_lanes": (lambda: gather_lanes_cuda(tabT, idx),
                         lambda: gather_lanes_plain(tabT, idx),
                         lambda: tabT[:, idx]),
        "gather_onehot": (lambda: gather_onehot_cuda(tab, idx),
                          lambda: gather_onehot_plain(tab, idx),
                          lambda: tab[idx]),
    }
    out = {}
    for name, (kern, plain, library) in cases.items():
        got = kern()
        ref = library()
        twin = plain()
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, ref)) and bool(torch.equal(twin, ref))
        err = float((got - ref).abs().max())
        del got, ref, twin
        bound, by = bound_ms(name)
        out[name] = dict(ms=cuda_ms(kern, REPS),
                         plain_ms=cuda_ms(plain, REPS // 10),
                         library_ms=cuda_ms(library, REPS),
                         bound_ms=bound, bound_by=by, exact=exact,
                         max_abs_err=err)
        r = out[name]
        print(f"{name:13s} N={N}: {r['ms']:.4f} ms ({N / r['ms'] / 1e6:.0f} "
              f"G idx/s), plain {r['plain_ms']:.4f} ms, tab[idx] "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({by}); bit-exact {exact}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m calclens_tpu_torch.tools.exp_gather")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), N=N, W=W,
                          F=F, kernels=res)))
    return 0 if all(r["exact"] for r in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
