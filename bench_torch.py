"""Headline benchmark of the PyTorch/CUDA port: rays/sec for one full
lens-plane step, the counterpart of bench.py.

    python bench_torch.py [--device cuda|cpu]

One step = deposit (BENCH_DEPOSIT: NGP, the default, CIC or SPH) + SHT
Poisson solve (map2alm, eight of them for SPH, -1/l(l+1) filter, 6-map
derivative synthesis) + bilinear/parallel-transport interpolation to every
ray + geodesic propagation, through calclens_tpu_torch's Raytracer.step.
bench.py's configuration, seed and protocol: one warm-up plane, then three
timed planes whose particles were staged on the device before, each ending
in torch.cuda.synchronize().  Shapes via env:
BENCH_SHT_ORDER (default 12 -> NSIDE 4096), BENCH_RAY_ORDER (default 10 ->
12.6M rays), BENCH_NPART (default 2^21 particles), BENCH_BUNDLE_ORDER
(default 3).  BENCH_MODE=MG benches the non-SHTONLY multigrid-refined step
at its design point: SHTOrder 10, rayOrder 12 (201M rays), bundleOrder 6
unless the variables above say otherwise, 10 fixed V-cycles, BENCH_DEPOSIT
choosing the SHT map's deposit and the patch deposit as in the driver.  The
metric name carries the mode and scheme as bench.py's does
(rays_per_sec_plane_step_sph_nside4096, ..._mg_nside1024).

After the timed planes, one more plane runs with Profile set: its phase row
(DEPOSIT, SHTSOLVE, SHT, RAYPROP seconds, each up to a device sync; the MG
step adds MGDEPOSIT, MGBC, MGSOLVE and MGINTERP) is printed as a JSON line,
beside the timed planes' median step time, their peak device memory
(peak_bytes: torch.cuda.max_memory_allocated after a reset; 0 on the CPU)
and the synthesis' j-blocks (synth_stream_blocks; BENCH_SHT_ORDER=13
BENCH_RAY_ORDER=12 is NSIDE 8192 on 201M rays, streamed over the plan's
default count).  The last line is one JSON object with bench.py's
keys; vs_baseline compares with the same measured reference throughput
(calclens_tpu_torch/benchconst.py).  It runs on the GPU and fails when
there is none; --device cpu runs it on the CPU (for tests, at small
shapes).  It imports neither jax nor calclens_tpu.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from calclens_tpu_torch.benchconst import (REF_CLUSTER_CORES,
                                           REF_MEASURED_STEP_S,
                                           reference_core_step_seconds)
from calclens_tpu_torch.config import RayTraceConfig
from calclens_tpu_torch.driver import Raytracer
from calclens_tpu_torch.sht import transforms as T

PROFILE_PHASES = ("DEPOSIT", "SHTSOLVE", "SHT", "RAYPROP")
MG_PHASES = ("MGDEPOSIT", "MGBC", "MGSOLVE", "MGINTERP")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python bench_torch.py")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: torch sees no CUDA device (--device cpu runs the "
              "bench on the CPU)", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    mode = os.environ.get("BENCH_MODE", "SHT")
    mg = mode == "MG"
    sht_order = int(os.environ.get("BENCH_SHT_ORDER", 10 if mg else 12))
    ray_order = int(os.environ.get("BENCH_RAY_ORDER", 12 if mg else 10))
    bundle_order = int(os.environ.get("BENCH_BUNDLE_ORDER", 6 if mg else 3))
    npart = int(os.environ.get("BENCH_NPART", 1 << 21))
    deposit = os.environ.get("BENCH_DEPOSIT", "NGP")
    if deposit not in ("NGP", "CIC", "SPH") or mode not in ("SHT", "MG"):
        raise ValueError(f"BENCH_DEPOSIT={deposit} BENCH_MODE={mode}")

    cfg = RayTraceConfig(
        OmegaM=0.3,
        maxComvDistance=2000.0,
        NumLensPlanes=8,
        SHTOrder=sht_order,
        rayOrder=ray_order,
        bundleOrder=bundle_order,
        Precision="f32",
        DepositScheme=deposit,
        SHTOnly=not mg,
    ).finalize()

    rt = Raytracer(cfg, device=dev)
    rt.init_rays()
    nrays = rt.rays_packed.shape[1]

    rng = np.random.default_rng(12)
    v = rng.normal(size=(npart, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    mass = np.full(npart, 1.0e12)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rt.step(1, pos=v * 375.0, mass=mass)  # warm-up
    sync()
    staged = {p: rt._pad_particles(v * (250.0 * p + 125.0), mass)
              for p in (2, 3, 4, 5)}
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for p in (2, 3, 4):
        pos_d, mass_d = staged[p]
        t0 = time.perf_counter()
        rt.step(p, pos=pos_d, mass=mass_d)
        sync()
        times.append(time.perf_counter() - t0)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # one more plane phase by phase (Profile), outside the timed planes
    rt.cfg.Profile = True
    rt.step(5, *staged[5])
    rt.cfg.Profile = False
    row = dict(rt.phase_rows)[5]
    phases = PROFILE_PHASES + (MG_PHASES if mg else ())
    print(json.dumps({"profile_plane": 5, "step_s": rt.timings[-1][1],
                      **{k.lower() + "_s": row[k] for k in phases},
                      "timed_per_plane_s": float(np.median(times)),
                      "peak_bytes": peak,
                      "synth_stream_blocks": T.synth_stream_blocks(rt.plan),
                      "synthesis_rings_mode": rt.plan.synthesis_rings_mode,
                      **({"mg_cycles": rt.mg_cycles[5]} if mg else {})}))

    per_plane = float(np.median(times))
    rays_per_sec = nrays / per_plane
    ref_core_step = reference_core_step_seconds(sht_order, ray_order)
    ref_core_rays = nrays / ref_core_step
    ref_cluster_rays = ref_core_rays * REF_CLUSTER_CORES
    tag = "" if (mode, deposit) == ("SHT", "NGP") else \
        f"_{mode.lower()}" if deposit == "NGP" else f"_{deposit.lower()}"
    print(json.dumps({
        "metric": f"rays_per_sec_plane_step{tag}_nside{1 << sht_order}",
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / ref_cluster_rays,
        "vs_baseline_per_core": rays_per_sec / ref_core_rays,
        "baseline_ref_core_s_per_plane": ref_core_step,
        "baseline_measured_at": sorted(REF_MEASURED_STEP_S),
        "per_plane_s": per_plane,
        "nrays": nrays,
        "npart": npart,
        "device": dev.type,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
