"""Roofline of the Legendre kernels on the card (P1).

    python -m calclens_tpu_torch.tools.roofline_legendre [--order 12]
        [--device cuda]

Counterpart of tools/roofline_legendre.py.  It makes "the recurrence is
the wall" a claim that a measurement can prove false:

  1. `ceilings()` times synthetic sweeps (csrc/roofline_probe.cu) at the
     TPU tool's default shape (TM=32, TJ=256, LB=128, MT=96, LBLK=64, i.e.
     6.44e9 (l, m, j) elements): the bare dependent three-term recurrence
     (`rec`), the same with every degree's value stored into K4's shared
     tile (`rec+store`), the stores alone (`store`), and 16 FP32 FMAs per
     element from shared memory (`dot`);
  2. `production(order)` times the port's K1, K2, K2-4col, K3 (both forms)
     and K4 at that order through their wrappers in sht/legendre.py,
     counts the elements each computes exactly (`element_counts`), and
     prints each kernel's share of the `rec` and `rec+store` ceilings; K2
     also on a polar and a belt range of J/8 ring pairs each.

A kernel at >= ~80 % of the rec+store ceiling is done by measurement: the
rest of its time is the recurrence and its stores at the speed this card
runs them.  One well below it has room.  The last line printed is a JSON
object of every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from . import (cuda_ms, no_tf32, require_cuda, sass as built_sass,
               sass_functions, sass_instructions)

MODES = ("rec", "rec+store", "store", "dot")
MODE_IDS = {m: i for i, m in enumerate(MODES)}
# FP32 operations per (l, m, j) element in the TPU tool's count: the
# recurrence's 3 multiplies and a subtraction; 16 FMAs for dot
FLOPS = {"rec": 4, "rec+store": 4, "store": 0, "dot": 32}
# issue slots per element that the rounding contract needs on the CUDA
# cores: the recurrence's 4 operations, each rounded on its own (no FMA),
# so rec is bound by issue slots, not by the FMA-counted FLOP rate
SLOTS = {"rec": 4}
DEFAULT_SHAPE = dict(MT=96, LBLK=64, LB=128, TM=32, TJ=256)
DOT_COLS = 16
CEILING_REPS = 5     # timed launches per mode, after a warm-up
PRODUCTION_REPS = 2  # per Legendre kernel (~0.4-1.1 s each at order 12)

# the kernel's limits (csrc/roofline_probe.cu): a block holds 512 (m, ring)
# pairs, 4 rings per thread; the store modes' tile is K4's, 16 degrees x
# (128 + 16) floats per warp; the coefficient rows hold LB + 2 (a, b) pairs
_PAIRS = 512
_TILE_BYTES = 4 * 16 * (128 + 16) * 4
_SMEM_MAX = 232448  # bytes of shared memory a block can use on Hopper
# degrees per unrolled group of the timed kernels (LB a multiple of it)
PROBE_GROUP = 16

# the card's shared-memory rate: 128 bytes per clock per SM
SMEM_BYTES_PER_CLOCK_PER_SM = 128


def default_geo(TJ: int, device="cpu"):
    """The TPU tool's geometry block: [5, TJ] uniform in (-0.9, 0.9) from
    numpy's seed 0; row 0 is cos theta."""
    g = np.random.default_rng(0).uniform(-0.9, 0.9, (5, TJ)).astype(np.float32)
    return torch.tensor(g, device=device)


def elements(MT, LBLK, LB, TM, TJ) -> int:
    return MT * LBLK * TM * LB * TJ


def _dot_matrix(LB: int, device):
    """S [16, LB]: S[k, i] = i * float32(0.01 k + 1), in float32."""
    sk = torch.tensor([np.float32(0.01 * k + 1.0) for k in range(DOT_COLS)],
                      device=device)
    return torch.arange(LB, dtype=torch.float32, device=device)[None, :] \
        * sk[:, None]


def probe_plain(MT, LBLK, LB, TM, TJ, mode, geo):
    """The probe's function in plain PyTorch (float32).  Rows m = 0 ..
    MT*TM-1, degrees l = 1 .. LBLK*LB; returns [MT, TM, TJ] (the last value
    of the recurrence, or 0.5 for `store`) or, for `dot`, [MT, TM, 16, TJ]
    (S contracted against a tile of 0.5, summed over the LBLK blocks)."""
    from ..sht.legendre import _coeffs

    dev = geo.device
    rows = MT * TM
    if mode == "store":
        return torch.full((MT, TM, TJ), 0.5, dtype=torch.float32, device=dev)
    if mode == "dot":
        S = _dot_matrix(LB, dev)
        P = torch.full((LB, TJ), 0.5, dtype=torch.float32, device=dev)
        acc = torch.zeros((DOT_COLS, TJ), dtype=torch.float32, device=dev)
        with no_tf32():
            for _ in range(LBLK):
                acc = acc + S @ P
        return acc.expand(MT, TM, DOT_COLS, TJ).contiguous()
    if mode not in ("rec", "rec+store"):
        raise ValueError(f"unknown probe mode {mode!r}; one of {MODES}")
    cth = geo[0][None, :]
    mf = torch.arange(rows, dtype=torch.float32, device=dev)
    pp = torch.zeros((rows, TJ), dtype=torch.float32, device=dev)
    pc = torch.full_like(pp, 0.5)
    for d in range(LBLK * LB):
        a, b = _coeffs(d + 1, mf)
        new = a[:, None] * (cth * pc - b[:, None] * pp)
        pp, pc = pc, new
    return pc.reshape(MT, TM, TJ)


def _check_shape(MT, LBLK, LB, TM, TJ, mode):
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}; one of {MODES}")
    if min(MT, LBLK, LB, TM, TJ) < 1:
        raise ValueError("every probe dimension must be positive")
    if TJ < 32 or TJ > _PAIRS or TJ & (TJ - 1):
        raise ValueError(f"TJ = {TJ}: the kernel takes a power of two in "
                         f"[32, {_PAIRS}]")
    coef = 8 * (_PAIRS // TJ) * (LB + 2)
    smem = {"rec": coef, "rec+store": coef + _TILE_BYTES,
            "store": _TILE_BYTES,
            "dot": _TILE_BYTES + 4 * DOT_COLS * LB}[mode]
    if smem > _SMEM_MAX:
        raise ValueError(f"{mode} at LB = {LB}, TJ = {TJ} needs {smem} bytes "
                         f"of shared memory, more than {_SMEM_MAX}")


def probe_cuda(MT, LBLK, LB, TM, TJ, mode, geo):
    """Launch the probe kernel (csrc/roofline_probe.cu) on geo's CUDA
    device and PyTorch's current stream.  Same contract as probe_plain."""
    from ..sht.legendre import _check_cuda_f32, _launch

    _check_shape(MT, LBLK, LB, TM, TJ, mode)
    _check_cuda_f32("roofline_probe", dict(geo=geo), dict(geo=(5, TJ)))
    shape = (MT, TM, DOT_COLS, TJ) if mode == "dot" else (MT, TM, TJ)
    out = torch.empty(shape, dtype=torch.float32, device=geo.device)
    _launch("roofline_probe", "roofline_probe_launch", geo.device,
            geo.data_ptr(), out.data_ptr(), MT * TM, TJ, LB, LBLK,
            MODE_IDS[mode])
    return out


def probe(MT, LBLK, LB, TM, TJ, mode, geo):
    """P1 wrapper: the kernel for a CUDA geo, the plain version for a CPU
    one."""
    if geo.device.type == "cpu":
        _check_shape(MT, LBLK, LB, TM, TJ, mode)
        return probe_plain(MT, LBLK, LB, TM, TJ, mode, geo)
    return probe_cuda(MT, LBLK, LB, TM, TJ, mode, geo)


def dot_library(MT, LBLK, LB, TM, TJ, geo):
    """The dot mode's function as one torch.bmm in FP32 (TF32 off): per
    row, S tiled over the LBLK blocks [16, LBLK*LB] times the 0.5 tile
    stacked [LBLK*LB, TJ]; both expanded over the rows, so the call does
    the probe's 32 operations per element."""
    dev = geo.device
    K = LBLK * LB
    S = _dot_matrix(LB, dev).repeat(1, LBLK)
    P = torch.full((K, TJ), 0.5, dtype=torch.float32, device=dev)
    rows = MT * TM
    with no_tf32():
        out = torch.bmm(S.expand(rows, DOT_COLS, K), P.expand(rows, K, TJ))
    return out.view(MT, TM, DOT_COLS, TJ)


def smem_peak_bytes_per_s():
    """The card's shared-memory peak: 128 B per clock per SM, times the SMs,
    times the SM clock that nvidia-smi gives as clocks.max.sm (MHz).  None
    where nvidia-smi does not answer."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        mhz = float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SMEM_BYTES_PER_CLOCK_PER_SM * sms * mhz * 1e6


# the redesigned sweeps: SASS function name part -> (kernel, rings per
# thread, degrees per group between two votes)
STEADY_KERNELS = {"legendre_synth_kernelILi8": ("legendre_synth", 4, 8),
                  "legendre_synth_kernelILi2": ("legendre_synth_phi", 4, 16),
                  "legendre_analysis_kernel": ("legendre_analysis", 4, 16),
                  "legendre_synth_vpu_kernelILi6": ("legendre_synth_vpu", 4,
                                                    8),
                  "legendre_synth_vpu_kernelILi2": ("legendre_synth_vpu_phi",
                                                    4, 16),
                  "legendre_analysis_dot_kernel": ("legendre_analysis_dot",
                                                   4, 16)}


def _steady_path(ins, head, tail):
    """The path from `head` to the backward branch at `tail` that runs no
    rescale test (FSETP, FMNMX) and no vote, staying inside the loop and
    visiting no address twice; of several, the one with the most FFMA and
    HMMA (the column sums; K4's contraction), then the shortest.  None if
    there is none."""
    at = {a: i for i, (a, _, _, _) in enumerate(ins)}
    best = None
    stack = [(at[head], [], frozenset())]
    while stack:
        i, path, seen = stack.pop()
        while True:
            a, op, pred, tgt = ins[i]
            base = op.split(".")[0]
            if (a in seen or not head <= a <= tail
                    or base in ("FSETP", "FMNMX", "VOTE", "EXIT")):
                break
            seen = seen | {a}
            path = path + [base]
            if a == tail:
                key = (path.count("FFMA") + path.count("HMMA"), -len(path))
                if best is None or key > best[0]:
                    best = (key, path)
                break
            if tgt is None:
                i += 1
            elif pred:  # both sides
                stack.append((at[tgt], path, seen))
                i += 1
            else:
                i = at[tgt]
    return None if best is None else best[1]


def steady_loop_sass(sass=None):
    """The SASS instructions of the redesigned K1-K4 loops once every ring
    of a warp is at scale k == 0: in the innermost loop that holds a vote
    (one group of degrees; for K1 with its cross-thread sum, for K4 with
    its contraction), the path from its head to its predicated backward
    branch that runs no rescale test and no vote.  Returns kernel ->
    dict(group, per_degree, per_element, cuda_core_per_element, ops), the
    last per element without the tensor cores' HMMA."""
    from collections import Counter

    out = {}
    for name, body in sass_functions(sass or built_sass()):
        key = next((k for k in STEADY_KERNELS if k in name), None)
        # K1 and K2 in their one-device instantiations: a rank's m-block
        # form (template argument kRowOffset true, "Lb1E") is left out
        if key is None or "Lb1E" in name:
            continue
        kernel, rings, group = STEADY_KERNELS[key]
        ins = sass_instructions(body)
        votes = [a for a, op, _, _ in ins if op.startswith("VOTE")]
        # a loop's backward branch is predicated (the vote's fallback for
        # divergent warps jumps back unconditionally)
        head, tail = min(((tgt, a) for a, _, pred, tgt in ins
                          if pred and tgt is not None and tgt < a
                          and any(tgt <= v <= a for v in votes)),
                         key=lambda lp: lp[1] - lp[0])
        path = _steady_path(ins, head, tail)
        if path is None:
            continue
        ops = Counter(path)
        out[kernel] = dict(group=len(path), per_degree=len(path) / group,
                           per_element=len(path) / group / rings,
                           cuda_core_per_element=(len(path) - ops["HMMA"])
                           / group / rings, ops=dict(ops))
    return out


def _probe_function(sass, mode):
    """The SASS body of the probe kernel that ceilings() times in `mode`
    (template arguments: the mode's id and the group of 16 degrees)."""
    tag = f"roofline_probe_kernelILi{MODE_IDS[mode]}ELi{PROBE_GROUP}E"
    for name, body in sass_functions(sass):
        if tag in name:
            return body
    raise RuntimeError(f"the {mode} probe kernel is not in the library")


# floats a shared-memory store instruction writes, by its width suffix
_STS_FLOATS = {"STS": 1, "STS.64": 2, "STS.128": 4}


def store_loop_check(sass=None):
    """Shows that nvcc kept the rec+store kernel's stores: in the built
    library's SASS (cuobjdump -sass), the instructions of the timed kernel's
    recurrence loop (between its last two barriers) counted by opcode, and
    the floats its shared-memory stores write (an STS.128 writes 4).  Each
    degree of the recurrence is 3 FMUL and 1 FADD per ring, so a loop that
    keeps its stores writes one float per FADD.  Returns dict(ops={opcode:
    count}, stored_floats)."""
    from collections import Counter

    body = _probe_function(sass or built_sass(), "rec+store")
    lines = body.split("\n")
    bars = [i for i, line in enumerate(lines) if "BAR.SYNC" in line]
    ops = Counter(op for _, op, _, _ in
                  sass_instructions("\n".join(lines[bars[-2]: bars[-1]])))
    base = Counter()
    for op, n in ops.items():
        base[op.split(".")[0]] += n
    stored = sum(_STS_FLOATS.get(op, 0) * n for op, n in ops.items())
    return dict(ops=dict(base), stored_floats=stored)


def rec_loop_sass(sass=None):
    """The SASS instructions of the timed rec kernel's sweep: its innermost
    loop (a backward branch with no other inside it) that holds the most
    FMUL, one group of PROBE_GROUP degrees of 4 rings per thread.  Returns
    dict(group, per_element, ops)."""
    from collections import Counter

    ins = sass_instructions(_probe_function(sass or built_sass(), "rec"))
    loops = [(tgt, a) for a, _, _, tgt in ins if tgt is not None and tgt < a]
    inner = [(h, t) for h, t in loops
             if not any(h <= h2 and t2 < t for h2, t2 in loops
                        if (h2, t2) != (h, t))]

    def body(loop):
        return [op.split(".")[0] for a, op, _, _ in ins
                if loop[0] <= a <= loop[1]]

    path = max((body(lp) for lp in inner), key=lambda b: b.count("FMUL"))
    return dict(group=len(path), per_element=len(path) / PROBE_GROUP / 4,
                ops=dict(Counter(path)))


def ceilings(device="cuda"):
    """Times every probe mode at the TPU tool's default shape with CUDA
    events (one warm-up launch, then the mean of CEILING_REPS).  Returns
    mode -> dict(ms, elems, gelem_s, tflops, store_gbs) and prints one line
    each."""
    dev = require_cuda(device)
    sh = DEFAULT_SHAPE
    geo = default_geo(sh["TJ"], dev)
    elems = elements(**sh)
    peak = smem_peak_bytes_per_s()
    out = {}
    for mode in MODES:
        ms = cuda_ms(lambda m=mode: probe_cuda(geo=geo, mode=m, **sh),
                     CEILING_REPS)
        r = dict(ms=ms, elems=elems, gelem_s=elems / ms / 1e6,
                 tflops=elems * FLOPS[mode] / ms / 1e9,
                 store_gbs=(elems * 4 / ms / 1e6 if "store" in mode
                            else None))
        line = (f"ceiling {mode:9s}: {ms:9.4f} ms {r['gelem_s']:8.1f} "
                f"G elem/s")
        if FLOPS[mode]:
            line += f"  {r['tflops']:6.2f} TFLOP/s (x{FLOPS[mode]})"
        if r["store_gbs"] is not None:
            line += f"  {r['store_gbs']:7.0f} GB/s stored to shared memory"
            if peak:
                line += (f" ({r['store_gbs'] * 1e9 / peak:.1%} of the "
                         f"shared-memory peak {peak / 1e12:.2f} TB/s)")
        print(line, flush=True)
        out[mode] = r
    return out


def element_counts(plan, rings=None):
    """(l, m, j) elements each Legendre kernel computes at this plan, over
    the ring pairs `rings` (a slice; all by default), following the port's
    own loops: for K1 and K4 only the (m, 512-ring tile) pairs below the
    tile's turning-point cutoff (sht/legendre.analysis_mcut), for K2 and K3
    (both forms each) those below the cutoff of their 128-ring tiles
    (synth_mcut).  Rings beyond J are not counted."""
    from ..sht.legendre import (ANALYSIS_TILE_J, SYNTH_TILE_J, analysis_mcut,
                                synth_mcut)

    nl, nm, J = plan.nl, plan.nm, plan.J
    tri_m = np.maximum(nl - np.arange(nm), 0).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(tri_m)])  # cum[c] = sum over m < c
    j = np.arange(J)[rings if rings is not None else slice(None)]
    ana = int(cum[analysis_mcut(plan.sth_host, nl, nm)[j // ANALYSIS_TILE_J]]
              .sum())
    synth = int(cum[synth_mcut(plan.sth_host, nl, nm)[j // SYNTH_TILE_J]]
                .sum())
    return {"legendre_analysis": ana, "legendre_analysis_dot": ana,
            "legendre_synth": synth, "legendre_synth_phi": synth,
            "legendre_synth_vpu": synth, "legendre_synth_vpu_phi": synth}


def shares(kernel_ms, counts, ceil):
    """name -> (G elem/s, share of the rec ceiling, share of rec+store):
    the kernel's element rate over each ceiling's element rate."""
    out = {}
    for name, ms in kernel_ms.items():
        rate = counts[name] / ms / 1e6
        out[name] = (rate, rate / ceil["rec"]["gelem_s"],
                     rate / ceil["rec+store"]["gelem_s"])
    return out


def _production_inputs(plan, seed=0):
    """Random alm with a red spectrum and random folded ring sums, from a
    numpy seed, on the plan's device."""
    from ..sht import legendre as TL

    rng = np.random.default_rng(seed)
    l = np.arange(plan.nl)[:, None]
    alm = ((rng.normal(size=(plan.nl, plan.nm))
            + 1j * rng.normal(size=(plan.nl, plan.nm))) / (1.0 + l) ** 2)
    alm = torch.tensor(alm.astype(np.complex64), device=plan.device)
    streams = TL.mx_prep(plan.nl, plan.nm, alm, torch.float32)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, plan.J))
                          + 1j * rng.normal(size=(plan.nm, plan.J))
                          ).astype(np.complex64), device=plan.device)
            for _ in range(2))
    return streams, TL.analysis_inputs(plan, E, O)


def production(order=12, device="cuda", ceil=None):
    """Times K1, K2, K2-4col, K3 (both forms, on a seed table written
    before) and K4 at `order` through their wrappers, and K2 on the polar and the belt J/8 ring
    pairs; prints each one's element rate and, given `ceil` (the result of
    ceilings()), its share of the rec and rec+store ceilings."""
    from ..sht import legendre as TL
    from ..sht.plan import SHTPlan

    dev = require_cuda(device)
    plan = SHTPlan(order, dev, dtype=torch.float32)
    streams, ana = _production_inputs(plan)
    a2 = streams[:2]
    g2 = (plan.cth, plan.ln_sth, plan.logc, plan.mcut(TL.SYNTH_TILE_J))
    g3 = (plan.cth, plan.sth, plan.cot, plan.inv_sth)
    seed = TL.chain_seed_cuda(plan.sth, plan.nm)  # K3 timed without it
    calls = {
        "legendre_analysis": lambda: TL.analysis_cuda(*ana, plan.nl),
        "legendre_analysis_dot": lambda: TL.analysis_dot_cuda(*ana, plan.nl),
        "legendre_synth": lambda: TL.synth_cuda(streams, *g2),
        "legendre_synth_phi": lambda: TL.synth_cuda(a2, *g2),
        "legendre_synth_vpu": lambda: TL.synth_vpu_cuda(*a2, *g3, True,
                                                        g2[3], seed),
        "legendre_synth_vpu_phi": lambda: TL.synth_vpu_cuda(*a2, *g3, False,
                                                            g2[3], seed),
    }
    ms = {}
    for name, fn in calls.items():
        ms[name] = cuda_ms(fn, PRODUCTION_REPS)
        torch.cuda.empty_cache()
    counts = element_counts(plan)
    J8 = plan.J // 8
    ranges = {"polar": slice(0, J8), "belt": slice(plan.J - J8, plan.J)}
    ranged = {}
    for label, sl in ranges.items():
        geo = tuple(x[sl].contiguous() for x in (plan.cth, plan.ln_sth))
        mcut = torch.as_tensor(TL.synth_mcut(plan.sth_host[sl], plan.nl,
                                             plan.nm), device=dev)
        t = cuda_ms(lambda: TL.synth_cuda(streams, *geo, plan.logc, mcut),
                    PRODUCTION_REPS)
        n = element_counts(plan, sl)["legendre_synth"]
        ranged[label] = dict(j0=sl.start, j1=sl.stop, ms=t, elems=n,
                             gelem_s=n / t / 1e6)
    out = dict(order=order, ms=ms, elems=counts, k2_ranges=ranged)
    print(f"\n== production kernels, order {order} ==", flush=True)
    if ceil is not None:
        out["shares"] = shares(ms, counts, ceil)
    for name in calls:
        line = (f"{name:22s} {ms[name]:9.2f} ms  {counts[name]:.4e} elem  "
                f"{counts[name] / ms[name] / 1e6:7.1f} G elem/s")
        if ceil is not None:
            _, s_rec, s_rs = out["shares"][name]
            line += f"  {s_rec:6.1%} of rec, {s_rs:6.1%} of rec+store"
        print(line, flush=True)
    for label, r in ranged.items():
        print(f"legendre_synth {label:5s} j[{r['j0']}:{r['j1']}]: "
              f"{r['ms']:9.3f} ms  {r['gelem_s']:7.1f} G elem/s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m calclens_tpu_torch.tools.roofline_legendre")
    ap.add_argument("--order", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_cuda(args.device)
    print(f"== synthetic ceilings {DEFAULT_SHAPE} ==", flush=True)
    ceil = ceilings(args.device)
    prod = production(args.order, args.device, ceil=ceil)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          ceilings=ceil, production=prod)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
