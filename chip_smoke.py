#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calclens_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device; imports neither jax nor calclens_tpu.  Phases, each
of which must pass:

  1. card: name and power limit (nvidia-smi), torch / CUDA versions; TF32
     is switched off for matmuls and cuDNN;
  2. build: the hand-written kernels (calclens_tpu_torch/csrc/*.cu) are
     compiled for sm_90a from the checkout, one nvcc per source;
  3. kernels vs twins: K1 (Legendre analysis), K2 (synthesis with
     derivatives, 16 columns), K2's potential-only form (4 columns), K3
     (bucketed synthesis, with and without derivatives) and K4
     (stored-lambda analysis) against their plain PyTorch twins on the
     card, on band-limited random inputs from a numpy seed, at orders 8 and
     10, bound max|kernel - twin| / max|twin| < 1e-5 per output column;
     all timed at order 10;
  4. CUDA vs CPU trace: the port's Raytracer at SHTOrder 7 / rayOrder 6,
     float32, three planes of seeded particles at pixel centres, once on
     the CPU (twins) and once on the card (kernels); the packed ray buffers
     must agree within 5e-4 of each quantity's max |value| after every
     plane.  Run twice: with the default kernels (K2, K1) and with the
     variant (K3, K4); each CUDA run must have launched its two kernels;
  5. headline: SHTOrder 12 (NSIDE 4096, lmax 12287), rayOrder 10
     (12,582,912 rays), 2^21 particles, float32, through Raytracer.step:
     one warm-up plane and three timed planes, with the kernel launch counts
     of exactly that run, the peak device memory and finite rays; then the
     variant headline (K3, K4): one warm-up plane and two timed planes, K3
     and K4 launched and K1 and K2 not, and the distance of its rays from
     the default run's rays after the same planes;
  6. the kernels at the headline shape: K1 and K2 against their twins
     (same 1e-5 bound); K2's 4-column form, K3 and K4 against their twins
     on a set of m rows (all rings, all degrees; the full twins would take
     minutes); K4 against K1 on the same inputs; alm2map (K2, 4 columns)
     against alm2allmaps(...)[0] (K2, 16 columns), its launch counted; K3's
     distance from K2 printed (the two seed lambda_mm differently), and
     each one's distance from float64 twins on the m rows, polar caps and
     belt apart; every kernel timed with CUDA events beside its bound from
     the shapes.

It prints the card's line, a JSON line {"kernels": [...]} with each
kernel's launches on its path's run, its error against its twin, its
times, its bound and the library column, and last {"ok": true, "device":
{...}}.  It exits non-zero, printing neither JSON line, when a phase fails
or there is no GPU.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

K1_BOUND = 1e-5   # kernel vs twin, relative to max |twin|
K2_BOUND = 1e-5
VARIANT_BOUND = 1e-5  # K3, K4, K2-4col vs twins; K4 vs K1; alm2map vs K2
# CUDA vs CPU trace, relative to each quantity's max |value|: 4x below the
# float32 trace's own distance from a float64 trace at these shapes (2e-3 on
# the A rows, measured on an H100), so the kernels' path must agree with
# the twins' far better than either agrees with the exact answer
TRACE_BOUND = 5e-4
# m rows on which the order-12 outputs of K2-4col, K3 and K4 are held to
# their twins: both parities, the first rows, and rows up to lmax
CHECK_ROWS = (0, 1, 2, 3, 511, 2048, 6143, 10001, 12287)

# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): FP32 outside
# the tensor cores, and device memory.
FP32_PEAK = 67e12   # FLOP/s
HBM_RATE = 3.35e12  # bytes/s
# FP32 operations per (l, m, j) element that the function needs (a fused
# multiply-add counts 2): the recurrence 5 (three multiplies, a
# subtraction, the scale multiply); K1 and K4 add 2 FMAs (re, im); K2 8
# FMAs (16 columns) or 2 (4 columns).  K3 with derivatives computes the
# same (qN, qS) as K2: its lambda' and lambda'' sums follow, summed by
# parts, from sums of a*lambda, l*a*lambda and l(l+1)*a*lambda, so the
# function needs K2's 21, although K3 forms lambda' and lambda'' per
# degree (11 more).  Per-degree coefficients are shared by a block's rings
# and not counted.
FLOPS_PER_ELEMENT = {"legendre_analysis": 9, "legendre_analysis_dot": 9,
                     "legendre_synth": 21, "legendre_synth_phi": 9,
                     "legendre_synth_vpu": 21}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*args):
    print(*args, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean milliseconds per call of fn on the current stream (CUDA events
    around `reps` calls, after one warm-up call)."""
    import torch

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


def timed_once(fn):
    """(result, CUDA-event milliseconds) of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def col_errs(got, ref):
    """(max over output columns of the relative error, max abs error) of
    [rows, ncol, J] outputs."""
    return (max(rel_err(got[:, c], ref[:, c]) for c in range(got.shape[1])),
            float((got - ref).abs().max()))


def pair_errs(got, ref):
    """The same for (re, im) pairs of alm outputs."""
    return (max(rel_err(got[0], ref[0]), rel_err(got[1], ref[1])),
            max(float((got[0] - ref[0]).abs().max()),
                float((got[1] - ref[1]).abs().max())))


def band_limited_inputs(order, dev, seed):
    """(plan, alm, K2 stream planes, K1 input tuple) at one order: random
    alm with a red spectrum; the K1 inputs are the folded ring sums of the
    potential map synthesized from it.  The first two K2 streams are the
    a-streams of K2's 4-column form and of K3."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.sht.plan import SHTPlan

    plan = SHTPlan(order, dev, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    l = np.arange(plan.nl)[:, None]
    m = np.arange(plan.nm)[None, :]
    alm = np.where(m <= l, (rng.normal(size=(plan.nl, plan.nm))
                            + 1j * rng.normal(size=(plan.nl, plan.nm)))
                   / (1.0 + l) ** 1.5, 0.0)
    alm[:, 0] = alm[:, 0].real
    alm = torch.tensor(alm.astype(np.complex64), device=dev)
    streams = TL.mx_prep(plan.nl, plan.nm, alm, torch.float32)
    phi = T.alm2allmaps(plan, alm)[0]
    E, O = T.fold_pairs(plan, T.analysis_rings(plan, phi))
    del phi
    return plan, alm, streams, TL.analysis_inputs(plan, E, O)


def compare_kernels(plan, streams, ana, reps):
    """K1 and K2 against their twins on the same inputs, with CUDA-event
    times: per kernel (max relative error over its output columns, max
    absolute error, kernel ms as the mean of `reps` launches after the
    compared one, twin ms of its one run)."""
    from calclens_tpu_torch.sht import legendre as TL

    geo = (plan.cth, plan.ln_sth, plan.logc)
    got = TL.synth_cuda(streams, *geo)
    ref, k2_twin_ms = timed_once(lambda: TL.synth_plain(streams, *geo))
    k2 = (*col_errs(got, ref),
          cuda_time_ms(lambda: TL.synth_cuda(streams, *geo), reps),
          k2_twin_ms)
    del got, ref
    got = TL.analysis_cuda(*ana, plan.nl)
    ref, k1_twin_ms = timed_once(lambda: TL.analysis_plain(*ana, plan.nl))
    k1 = (*pair_errs(got, ref),
          cuda_time_ms(lambda: TL.analysis_cuda(*ana, plan.nl), reps),
          k1_twin_ms)
    return k1, k2


def variant_calls(plan, streams, ana):
    """name -> (kernel call, twin call on rows m or all rows, error pair
    function) for K2's 4-column form, K3 in both forms and K4."""
    from calclens_tpu_torch.sht import legendre as TL

    a2 = streams[:2]
    g2 = (plan.cth, plan.ln_sth, plan.logc)
    g3 = (plan.cth, plan.sth, plan.cot, plan.inv_sth)

    def rows(x, m):
        return x if m is None else x[m]

    def k2phi_twin(m):
        return TL.synth_plain(tuple(rows(a, m) for a in a2), plan.cth,
                              plan.ln_sth, rows(plan.logc, m), m=m)

    def k3_twin(derivs):
        return lambda m: TL.synth_vpu_plain(rows(a2[0], m), rows(a2[1], m),
                                            *g3, derivs, m=m)

    def k4_twin(m):
        return TL.analysis_dot_plain(*(rows(x, m) for x in ana[:4]),
                                     plan.cth, plan.ln_sth,
                                     rows(plan.logc, m), ana[7], plan.nl,
                                     m=m)

    return {
        "K2-4col legendre_synth_phi": (
            lambda: TL.synth_cuda(a2, *g2), k2phi_twin, col_errs),
        "K3 legendre_synth_vpu": (
            lambda: TL.synth_vpu_cuda(*a2, *g3, True), k3_twin(True),
            col_errs),
        "K3 legendre_synth_vpu (phi only)": (
            lambda: TL.synth_vpu_cuda(*a2, *g3, False), k3_twin(False),
            col_errs),
        "K4 legendre_analysis_dot": (
            lambda: TL.analysis_dot_cuda(*ana, plan.nl), k4_twin, pair_errs),
    }


def compare_variants(plan, streams, ana, reps):
    """Each variant kernel against its full twin: name -> (rel, abs,
    kernel ms, twin ms)."""
    import torch

    out = {}
    for name, (kern, twin, errs) in variant_calls(plan, streams,
                                                  ana).items():
        got = kern()
        ref, twin_ms = timed_once(lambda: twin(None))
        out[name] = (*errs(got, ref), cuda_time_ms(kern, reps), twin_ms)
        del got, ref
        torch.cuda.empty_cache()
    return out


def check_variant_rows(plan, streams, ana, reps):
    """At the headline shape: each variant kernel's full output, on the
    CHECK_ROWS rows, against its twin run on those rows alone: name ->
    (rel, abs, kernel ms)."""
    import torch

    m = torch.tensor(CHECK_ROWS, device=plan.device)
    out = {}
    for name, (kern, twin, errs) in variant_calls(plan, streams,
                                                  ana).items():
        got = kern()
        got = got[m] if isinstance(got, torch.Tensor) else tuple(
            x[m] for x in got)
        out[name] = (*errs(got, twin(m)), cuda_time_ms(kern, reps))
        del got
        torch.cuda.empty_cache()
    return out


def kernel_bounds(plan, mcut):
    """name -> (bound ms, "operations" or "bytes") at this plan's shape:
    the larger of the FP32 operations over FP32_PEAK and the bytes that
    must move (each input read once, each output written once) over
    HBM_RATE.  Element counts follow the work these inputs need: the
    triangle l >= m for the synthesis kernels, and for the analysis kernels
    only the (m, ring tile) pairs below the tile's turning-point cutoff."""
    nl, nm, J = plan.nl, plan.nm, plan.J
    tile = 512
    tri_m = np.maximum(nl - np.arange(nm), 0).astype(np.float64)  # per m
    tri = float(tri_m.sum())
    rings = [min(tile, J - t) for t in range(0, J, tile)]
    cut = np.asarray(mcut.cpu() if hasattr(mcut, "cpu") else mcut)
    ana_elems = sum(r * float(tri_m[:c].sum()) for r, c in zip(rings, cut))
    ana_in = sum(r * int(c) for r, c in zip(rings, cut))  # (m, j) needed
    f4 = 4.0
    work = {
        "legendre_analysis": (ana_elems, f4 * (4 * ana_in + 2 * tri + 2 * J)),
        "legendre_synth": (tri * J, f4 * (4 * tri + 16 * nm * J + 2 * J)),
        "legendre_synth_phi": (tri * J, f4 * (2 * tri + 4 * nm * J + 2 * J)),
        "legendre_synth_vpu": (tri * J, f4 * (2 * tri + 12 * nm * J + 4 * J)),
    }
    work["legendre_analysis_dot"] = work["legendre_analysis"]
    out = {}
    for name, (elems, nbytes) in work.items():
        t_ops = elems * FLOPS_PER_ELEMENT[name] / FP32_PEAK
        t_mem = nbytes / HBM_RATE
        out[name] = (1e3 * max(t_ops, t_mem),
                     "operations" if t_ops >= t_mem else "bytes")
    return out


def distance_from_f64(plan, alm, q2, q3):
    """How far K2's and K3's float32 (qN, qS) lie from the exact answer, on
    the CHECK_ROWS rows: float64 twins of both (they agree to round-off, a
    check that the reference does not depend on the seed) on a float64
    plan.  Returns (twins' distance, {kernel: ([(cap, belt) per quantity],
    [d_theta per row])}), each max |q - ref| / max |ref| of the quantity
    over those rows; the polar caps are the ring pairs j < nside (theta <=
    48.2 deg), the belt the rest."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.sht.plan import SHTPlan

    p64 = SHTPlan(plan.order, plan.device, dtype=torch.float64)
    m = torch.tensor(CHECK_ROWS, device=plan.device)
    sub = tuple(x[m] for x in TL.mx_prep(p64.nl, p64.nm,
                                         alm.to(torch.complex128),
                                         torch.float64))
    ref = TL.q_from_columns(p64, TL.synth_plain(
        sub, p64.cth, p64.ln_sth, p64.logc[m], m=m), m=m)
    ref3 = TL.q_from_buckets(p64, TL.synth_vpu_plain(
        sub[0], sub[1], p64.cth, p64.sth, p64.cot, p64.inv_sth, True, m=m),
        m=m)
    twins = max(rel_err(ref3[h][k], ref[h][k]) for h in (0, 1)
                for k in range(3))
    cap = torch.arange(plan.J, device=plan.device) < plan.nside
    out = {}
    for name, q in (("K2", q2), ("K3", q3)):
        per_q, per_row = [], None
        for k in range(3):
            scale = max(float(ref[h][k].abs().max()) for h in (0, 1))
            d = torch.stack([(q[h][k][m].to(torch.complex128)
                              - ref[h][k]).abs() for h in (0, 1)])
            per_q.append((float(d[..., cap].max()) / scale,
                          float(d[..., ~cap].max()) / scale))
            if k == 1:
                per_row = (d.amax(dim=(0, 2)) / scale).tolist()
        out[name] = (per_q, per_row)
    return twins, out


def grouped_row_err(got, ref):
    """Max over packed rows of |got - ref| / max|ref| of the row's quantity
    (n, beta, A, Aprev, alpha, U, phi)."""
    groups = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))
    worst = 0.0
    for a, b in groups:
        scale = float(ref[a:b].abs().max()) or 1.0
        worst = max(worst, float((got[a:b] - ref[a:b]).abs().max()) / scale)
    return worst


def seeded_particles(n, radius, seed):
    """n particles of 1e12 Msun/h in random directions at one radius."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * radius, np.full(n, 1.0e12)


def pixel_centre_particles(cfg, cosmo, plane, n, seed):
    """n particles at the centres of random SHTOrder pixels of a plane,
    their total mass that of the plane's mean background density (so the
    scaled density map has the density contrast of a lightcone shell, not a
    monopole 300x its fluctuations).  At pixel centres the NGP pixel of a
    particle cannot flip between two evaluations that round differently;
    a flip moves a particle's whole mass to a neighbour pixel."""
    from calclens_tpu_torch.driver import plane_params
    from calclens_tpu_torch.healpix import core as hp

    pp = plane_params(cfg, cosmo, plane)
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 12 * 4**cfg.SHTOrder, size=n)
    pos = hp.pix2vec_ring(pix, cfg.SHTOrder) * pp.rad
    return pos, np.full(n, pp.backdens * 4.0 * np.pi / pp.densfact / n)


# the kernels each pair of selectors runs on the plane step
PATH_KERNELS = {("k2", "k1"): ("legendre_synth", "legendre_analysis"),
                ("k3", "k4"): ("legendre_synth_vpu", "legendre_analysis_dot")}


def trace_cuda_vs_cpu(synth, analysis):
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=7, rayOrder=6, bundleOrder=3,
                         Precision="f32").finalize()
    cpu = Raytracer(cfg, device="cpu")
    gpu = Raytracer(cfg, device="cuda")
    for rt in (cpu, gpu):
        rt.plan.synth_kernel, rt.plan.analysis_kernel = synth, analysis
        rt.init_rays()
    _ext.reset_launches()
    errs = []
    for p in range(3):
        pos, mass = pixel_centre_particles(cfg, cpu.cosmo, p, 20000, 100 + p)
        cpu.step(p, pos=pos, mass=mass)
        gpu.step(p, pos=pos, mass=mass)
        errs.append(grouped_row_err(gpu.rays_packed.cpu(), cpu.rays_packed))
    counts = dict(_ext.launches)
    check(all(counts[k] >= 3 for k in PATH_KERNELS[(synth, analysis)]),
          f"CUDA trace ({synth}, {analysis}) did not launch its kernels: "
          f"{counts}")
    check(bool(torch.isfinite(gpu.rays_packed).all()), "non-finite rays")
    return errs, counts


def headline(synth, analysis, planes, snapshot_after):
    """The plane step at the headline shape with the given kernels: plane
    1 as warm-up, then `planes` timed; the launch counts of exactly those
    planes, peak device memory, and a host copy of the rays after plane
    `snapshot_after`."""
    import torch
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=12, rayOrder=10, bundleOrder=3,
                         Precision="f32").finalize()
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device="cuda")
    rt.plan.synth_kernel, rt.plan.analysis_kernel = synth, analysis
    rt.init_rays()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nrays = rt.rays_packed.shape[1]
    npart = 1 << 21
    pos, mass = seeded_particles(npart, 1.0, 12)
    staged = {p: rt._pad_particles(pos * (250.0 * p + 125.0), mass)
              for p in (1, *planes)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    rt.step(1, *staged[1])  # warm-up plane
    times = []
    snap = None
    for p in planes:
        t = time.perf_counter()
        rt.step(p, *staged[p])  # ends in torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if p == snapshot_after:
            snap = rt.rays_packed.cpu()
    counts = dict(_ext.launches)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(rt.rays_packed).all())
    check(finite, f"headline ({synth}, {analysis}): non-finite ray rows")
    ran = PATH_KERNELS[(synth, analysis)]
    check(all(counts[k] > 0 for k in ran) and
          all(v == 0 for k, v in counts.items() if k not in ran),
          f"headline ({synth}, {analysis}): launches {counts}, expected "
          f"only {ran}")
    return dict(setup_s=setup_s, times=times, nrays=nrays, npart=npart,
                counts=counts, peak=peak, shape=tuple(rt.rays_packed.shape),
                snap=snap)


def report_headline(label, h):
    per_plane = float(np.median(h["times"]))
    say(f"{label} SHTOrder 12 / rayOrder 10 / 2^21 particles f32: "
        f"planes {', '.join(f'{t:.4f}' for t in h['times'])} s, "
        f"median {per_plane:.4f} s/plane, {h['nrays'] / per_plane:.0f} "
        f"rays/s, peak {h['peak'] / 2**30:.2f} GiB, setup "
        f"{h['setup_s']:.2f} s, launches {h['counts']}, rays {h['shape']} "
        f"finite")


def main():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA device")
    import calclens_tpu_torch  # noqa: F401  (fails outside the checkout)
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.sht import legendre as TL
    from calclens_tpu_torch.sht import transforms as T

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _ext.lib()
    say(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_ext.build_seconds if _ext.build_seconds is not None else 'cached'})")
    for src, log in _ext.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {src}: {line.strip()}")

    # 3. kernels vs twins at orders 8 and 10; times at order 10
    variants10 = None
    for order, reps in ((8, 1), (10, 5)):
        plan, _, streams, ana = band_limited_inputs(order, dev, order)
        k1, k2 = compare_kernels(plan, streams, ana, reps)
        for name, k, bound in (("K1 legendre_analysis", k1, K1_BOUND),
                               ("K2 legendre_synth", k2, K2_BOUND)):
            say(f"order {order} {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
                f"(bound {bound:g}); kernel {k[2]:.3f} ms, twin "
                f"{k[3]:.1f} ms")
            check(k[0] < bound, f"{name} off its twin at order {order}: "
                  f"{k[0]:.3e}")
        variants = compare_variants(plan, streams, ana, reps)
        for name, k in variants.items():
            say(f"order {order} {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
                f"(bound {VARIANT_BOUND:g}); kernel {k[2]:.3f} ms, twin "
                f"{k[3]:.1f} ms")
            check(k[0] < VARIANT_BOUND, f"{name} off its twin at order "
                  f"{order}: {k[0]:.3e}")
        variants10 = variants
        del plan, streams, ana
        torch.cuda.empty_cache()

    # 4. CUDA vs CPU trace, default and variant kernels
    for synth, analysis in PATH_KERNELS:
        errs, counts = trace_cuda_vs_cpu(synth, analysis)
        say(f"trace order 7/6 f32 ({synth}, {analysis}), CUDA vs CPU per "
            f"plane: {', '.join(f'{e:.3e}' for e in errs)} "
            f"(bound {TRACE_BOUND:g}); launches {counts}")
        check(max(errs) < TRACE_BOUND, f"CUDA trace ({synth}, {analysis}) "
              f"off the CPU trace: {errs}")
        torch.cuda.empty_cache()

    # 5. headline shape through Raytracer.step, default then variant
    h = headline("k2", "k1", (2, 3, 4), snapshot_after=3)
    report_headline("headline", h)
    torch.cuda.empty_cache()
    hv = headline("k3", "k4", (2, 3), snapshot_after=3)
    report_headline("variant headline (k3, k4)", hv)
    dist = grouped_row_err(hv["snap"], h["snap"])
    say(f"variant headline rays vs default after planes 1-3: {dist:.3e} of "
        f"each quantity's max")
    check(math.isfinite(dist), "variant headline: distance not finite")
    del h["snap"], hv["snap"]
    torch.cuda.empty_cache()

    # 6. the kernels at the headline shape
    plan, alm, streams, ana = band_limited_inputs(12, dev, 12)
    k1, k2 = compare_kernels(plan, streams, ana, reps=3)
    for name, k, bound in (("K1 legendre_analysis", k1, K1_BOUND),
                           ("K2 legendre_synth", k2, K2_BOUND)):
        say(f"order 12 {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
            f"(bound {bound:g}); kernel {k[2]:.2f} ms, twin {k[3]:.0f} ms")
        check(k[0] < bound, f"{name} off its twin at order 12: {k[0]:.3e}")
    rows12 = check_variant_rows(plan, streams, ana, reps=2)
    for name, k in rows12.items():
        say(f"order 12 {name}: rows {CHECK_ROWS} rel {k[0]:.3e} abs "
            f"{k[1]:.3e} (bound {VARIANT_BOUND:g}); kernel {k[2]:.2f} ms")
        check(k[0] < VARIANT_BOUND, f"{name} off its twin on rows at "
              f"order 12: {k[0]:.3e}")
    # K4 against K1: the same lambda bits, sums in another order
    k4vk1 = pair_errs(TL.analysis_dot_cuda(*ana, plan.nl),
                      TL.analysis_cuda(*ana, plan.nl))
    say(f"order 12 K4 vs K1: rel {k4vk1[0]:.3e} abs {k4vk1[1]:.3e} "
        f"(bound {VARIANT_BOUND:g})")
    check(k4vk1[0] < VARIANT_BOUND, f"K4 off K1 at order 12: {k4vk1[0]:.3e}")
    # alm2map (K2, 4 columns) against the potential of alm2allmaps (K2, 16)
    ref_phi = T.alm2allmaps(plan, alm)[0]
    _ext.reset_launches()
    phi = T.alm2map(plan, alm)
    torch.cuda.synchronize()
    phi_launches = _ext.launches["legendre_synth_phi"]
    check(phi_launches == 1, f"alm2map launched {dict(_ext.launches)}")
    phi_err = rel_err(phi, ref_phi)
    say(f"order 12 alm2map (K2-4col) vs alm2allmaps[0] (K2-16): rel "
        f"{phi_err:.3e} (bound {VARIANT_BOUND:g}); launches "
        f"{phi_launches}")
    check(phi_err < VARIANT_BOUND, f"alm2map off alm2allmaps: {phi_err:.3e}")
    del phi, ref_phi
    # K3 against K2 on the same alm: printed, not bounded
    q2 = T.legendre_synthesis(plan, alm, True)
    plan.synth_kernel = "k3"
    q3 = T.legendre_synthesis(plan, alm, True)
    plan.synth_kernel = "k2"
    k3vk2 = [max(rel_err(q3[h_][k], q2[h_][k]) for h_ in (0, 1))
             for k in range(3)]
    say(f"order 12 K3 vs K2 (qN, qS) distance, phi / d_theta / "
        f"d_theta_theta: {', '.join(f'{e:.3e}' for e in k3vk2)} of max|K2|")
    t0 = time.perf_counter()
    twins64, to64 = distance_from_f64(plan, alm, q2, q3)
    say(f"order 12 float64 twins of K2 and K3 on rows {CHECK_ROWS}: "
        f"{twins64:.3e} apart ({time.perf_counter() - t0:.1f} s)")
    for name, (per_q, per_row) in to64.items():
        say(f"order 12 {name} vs float64 on rows {CHECK_ROWS}, phi / "
            f"d_theta / d_theta_theta, polar caps | belt: "
            f"{', '.join(f'{c:.3e} | {b:.3e}' for c, b in per_q)}; "
            f"d_theta per row: {', '.join(f'{e:.2e}' for e in per_row)}")
    check(twins64 < 1e-9 and all(
        math.isfinite(x) for per_q, per_row in to64.values()
        for x in (*sum(per_q, ()), *per_row)),
        f"float64 references: twins {twins64:.3e} apart or non-finite")
    del q2, q3
    torch.cuda.empty_cache()

    bounds = kernel_bounds(plan, ana[7])
    for name, (b, by) in bounds.items():
        say(f"order 12 bound {name}: {b:.3f} ms ({by})")
    v10 = {k.split()[1]: v for k, v in variants10.items()
           if "phi only" not in k}
    v12 = {k.split()[1]: v for k, v in rows12.items() if "phi only" not in k}

    def entry(name, source, replaces, launches, err, ms, plain_ms, **extra):
        return dict(name=name, route="cuda",
                    source=f"calclens_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bounds[name][0],
                    bound_by=bounds[name][1], library_ms=None, **extra)

    # the variant kernels' twins are timed at order 10 (at order 12 they
    # take minutes), their errors are the order-12 row checks
    kernels = [
        entry("legendre_analysis", "legendre_analysis.cu",
              "calclens_tpu/sht/pallas_legendre.py:251",
              h["counts"]["legendre_analysis"], k1[1], k1[2], k1[3]),
        entry("legendre_synth", "legendre_synth.cu",
              "calclens_tpu/sht/pallas_legendre_mx.py:124",
              h["counts"]["legendre_synth"], k2[1], k2[2], k2[3]),
        entry("legendre_synth_phi", "legendre_synth.cu",
              "calclens_tpu/sht/pallas_legendre_mx.py:124",
              phi_launches, v12["legendre_synth_phi"][1],
              v12["legendre_synth_phi"][2], v10["legendre_synth_phi"][3],
              plain_order=10),
        entry("legendre_synth_vpu", "legendre_synth_vpu.cu",
              "calclens_tpu/sht/pallas_legendre.py:49",
              hv["counts"]["legendre_synth_vpu"],
              v12["legendre_synth_vpu"][1], v12["legendre_synth_vpu"][2],
              v10["legendre_synth_vpu"][3], plain_order=10),
        entry("legendre_analysis_dot", "legendre_analysis_dot.cu",
              "calclens_tpu/sht/pallas_legendre.py:477",
              hv["counts"]["legendre_analysis_dot"],
              v12["legendre_analysis_dot"][1],
              v12["legendre_analysis_dot"][2],
              v10["legendre_analysis_dot"][3], plain_order=10),
    ]
    check(all(math.isfinite(k[f]) for k in kernels
              for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")),
          "non-finite kernel measurement")
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on its path: {kernels}")
    say(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    say(card)  # nvidia-smi's own line: name, power limit
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
