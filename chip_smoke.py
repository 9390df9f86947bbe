#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calclens_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device; imports no jax.  Phases, each of which must pass:

  1. card: name and power limit (nvidia-smi), torch / CUDA versions; TF32
     is switched off for matmuls and cuDNN;
  2. build: the hand-written kernels (calclens_tpu_torch/csrc/*.cu) are
     compiled for sm_90a from the checkout;
  3. kernels vs twins: K1 (Legendre analysis) and K2 (Legendre synthesis
     with derivatives) against their plain PyTorch twins on the card, on
     band-limited random inputs from a numpy seed, at order 8 (NSIDE 256),
     bound max|kernel - twin| / max|twin| < 1e-5; both timed at order 10;
  4. CUDA vs CPU trace: the port's Raytracer at SHTOrder 7 / rayOrder 6,
     float32, three planes of seeded particles at pixel centres, once on
     the CPU (twins) and once on the card (kernels); the packed ray buffers
     must agree within 5e-4 of each quantity's max |value| after every
     plane, and the CUDA run must have launched both kernels;
  5. headline: SHTOrder 12 (NSIDE 4096, lmax 12287), rayOrder 10
     (12,582,912 rays), 2^21 particles, float32, through Raytracer.step:
     one warm-up plane and three timed planes, with the kernel launch counts
     of exactly that run, the peak device memory and finite rays;
  6. the kernels at the headline shape: each against its twin (same 1e-5
     bound), timed with CUDA events.

It prints the card's line, a JSON line {"kernels": [...]} with each
kernel's launches on the headline run, its error and times at the headline
shape, and last {"ok": true, "device": {...}}.  It exits non-zero, printing
neither JSON line, when a phase fails or there is no GPU.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

K1_BOUND = 1e-5   # kernel vs twin, relative to max |twin|
K2_BOUND = 1e-5
# CUDA vs CPU trace, relative to each quantity's max |value|: 4x below the
# float32 trace's own distance from a float64 trace at these shapes (2e-3 on
# the A rows, measured on an H100), so the kernels' path must agree with
# the twins' far better than either agrees with the exact answer
TRACE_BOUND = 5e-4


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


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def band_limited_inputs(order, dev, seed):
    """(plan, K2 stream planes, K1 input tuple) at one order: random alm
    with a red spectrum; the K1 inputs are the folded ring sums of the
    potential map synthesized from it."""
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
    return plan, streams, TL.analysis_inputs(plan, E, O)


def compare_kernels(plan, streams, ana_args, reps):
    """Each kernel against its twin on the same inputs, with CUDA-event
    times: per kernel (max relative error over its output columns, max
    absolute error, kernel ms as the mean of `reps` launches after the
    compared one, twin ms of its one run)."""
    import torch
    from calclens_tpu_torch.sht import legendre as TL

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)

    geo = (plan.cth, plan.ln_sth, plan.logc)
    got = TL.synth_cuda(*streams, *geo)
    ref, k2_twin_ms = timed(lambda: TL.synth_plain(*streams, *geo))
    k2 = (max(rel_err(got[:, c], ref[:, c]) for c in range(16)),
          float((got - ref).abs().max()),
          cuda_time_ms(lambda: TL.synth_cuda(*streams, *geo), reps),
          k2_twin_ms)
    del got, ref
    re, im = TL.analysis_cuda(*ana_args, plan.nl)
    (rre, rim), k1_twin_ms = timed(lambda: TL.analysis_plain(*ana_args,
                                                             plan.nl))
    k1 = (max(rel_err(re, rre), rel_err(im, rim)),
          max(float((re - rre).abs().max()), float((im - rim).abs().max())),
          cuda_time_ms(lambda: TL.analysis_cuda(*ana_args, plan.nl), reps),
          k1_twin_ms)
    return k1, k2


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
    from calclens_tpu.healpix import core as hp
    from calclens_tpu_torch.driver import plane_params

    pp = plane_params(cfg, cosmo, plane)
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 12 * 4**cfg.SHTOrder, size=n)
    pos = hp.pix2vec_ring(pix, cfg.SHTOrder) * pp.rad
    return pos, np.full(n, pp.backdens * 4.0 * np.pi / pp.densfact / n)


def trace_cuda_vs_cpu():
    import torch
    from calclens_tpu.config import RayTraceConfig
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.driver import Raytracer

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=7, rayOrder=6, bundleOrder=3,
                         Precision="f32").finalize()
    cpu = Raytracer(cfg, device="cpu")
    gpu = Raytracer(cfg, device="cuda")
    cpu.init_rays()
    gpu.init_rays()
    _ext.reset_launches()
    errs = []
    for p in range(3):
        pos, mass = pixel_centre_particles(cfg, cpu.cosmo, p, 20000, 100 + p)
        cpu.step(p, pos=pos, mass=mass)
        gpu.step(p, pos=pos, mass=mass)
        errs.append(grouped_row_err(gpu.rays_packed.cpu(), cpu.rays_packed))
    counts = dict(_ext.launches)
    check(counts["legendre_analysis"] >= 3 and counts["legendre_synth"] >= 3,
          f"CUDA trace did not launch both kernels: {counts}")
    check(bool(torch.isfinite(gpu.rays_packed).all()), "non-finite rays")
    return errs, counts


def headline():
    import torch
    from calclens_tpu.config import RayTraceConfig
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.driver import Raytracer

    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=12, rayOrder=10, bundleOrder=3,
                         Precision="f32").finalize()
    t0 = time.perf_counter()
    rt = Raytracer(cfg, device="cuda")
    rt.init_rays()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nrays = rt.rays_packed.shape[1]
    npart = 1 << 21
    pos, mass = seeded_particles(npart, 1.0, 12)
    staged = {p: rt._pad_particles(pos * (250.0 * p + 125.0), mass)
              for p in (1, 2, 3, 4)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launches()
    rt.step(1, *staged[1])  # warm-up plane
    times = []
    for p in (2, 3, 4):
        t = time.perf_counter()
        rt.step(p, *staged[p])  # ends in torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = dict(_ext.launches)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(rt.rays_packed).all())
    check(finite, "headline: non-finite ray rows")
    check(all(v > 0 for v in counts.values()),
          f"headline: a kernel was never launched: {counts}")
    return dict(setup_s=setup_s, times=times, nrays=nrays, npart=npart,
                counts=counts, peak=peak, shape=tuple(rt.rays_packed.shape))


def main():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA device")
    import calclens_tpu_torch  # noqa: F401  (fails outside the checkout)
    from calclens_tpu_torch import _ext

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

    # 3. kernels vs twins at order 8; times at order 10
    for order, reps in ((8, 1), (10, 5)):
        plan, streams, ana = band_limited_inputs(order, dev, order)
        k1, k2 = compare_kernels(plan, streams, ana, reps)
        for name, k, bound in (("K1 legendre_analysis", k1, K1_BOUND),
                               ("K2 legendre_synth", k2, K2_BOUND)):
            say(f"order {order} {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
                f"(bound {bound:g}); kernel {k[2]:.3f} ms, twin "
                f"{k[3]:.1f} ms")
            check(k[0] < bound, f"{name} off its twin at order {order}: "
                  f"{k[0]:.3e}")
        del plan, streams, ana
        torch.cuda.empty_cache()

    # 4. CUDA vs CPU trace
    errs, counts = trace_cuda_vs_cpu()
    say(f"trace order 7/6 f32, CUDA vs CPU per plane: "
        f"{', '.join(f'{e:.3e}' for e in errs)} (bound {TRACE_BOUND:g}); "
        f"launches {counts}")
    check(max(errs) < TRACE_BOUND, f"CUDA trace off the CPU trace: {errs}")
    torch.cuda.empty_cache()

    # 5. headline shape through Raytracer.step
    h = headline()
    per_plane = float(np.median(h["times"]))
    say(f"headline SHTOrder 12 / rayOrder 10 / 2^21 particles f32: "
        f"planes {', '.join(f'{t:.4f}' for t in h['times'])} s, "
        f"median {per_plane:.4f} s/plane, {h['nrays'] / per_plane:.0f} rays/s, "
        f"peak {h['peak'] / 2**30:.2f} GiB, setup {h['setup_s']:.2f} s, "
        f"launches {h['counts']}, rays {h['shape']} finite")
    torch.cuda.empty_cache()

    # 6. the kernels at the headline shape
    plan, streams, ana = band_limited_inputs(12, dev, 12)
    k1, k2 = compare_kernels(plan, streams, ana, reps=3)
    for name, k, bound in (("K1 legendre_analysis", k1, K1_BOUND),
                           ("K2 legendre_synth", k2, K2_BOUND)):
        say(f"order 12 {name}: rel {k[0]:.3e} abs {k[1]:.3e} "
            f"(bound {bound:g}); kernel {k[2]:.2f} ms, twin {k[3]:.0f} ms")
        check(k[0] < bound, f"{name} off its twin at order 12: {k[0]:.3e}")

    kernels = [
        dict(name="legendre_analysis", route="cuda",
             source="calclens_tpu_torch/csrc/legendre_analysis.cu",
             replaces="calclens_tpu/sht/pallas_legendre.py:251",
             launches=h["counts"]["legendre_analysis"], max_abs_err=k1[1],
             ms=k1[2], plain_ms=k1[3]),
        dict(name="legendre_synth", route="cuda",
             source="calclens_tpu_torch/csrc/legendre_synth.cu",
             replaces="calclens_tpu/sht/pallas_legendre_mx.py:124",
             launches=h["counts"]["legendre_synth"], max_abs_err=k2[1],
             ms=k2[2], plain_ms=k2[3]),
    ]
    check(all(math.isfinite(k[f]) for k in kernels
              for f in ("max_abs_err", "ms", "plain_ms")),
          "non-finite kernel measurement")
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
