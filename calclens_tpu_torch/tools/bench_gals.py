"""Galaxy grid-search throughput of the port, the counterpart of
tools/bench_gals.py:

    python -m calclens_tpu_torch.tools.bench_gals [--device cuda|cpu]

Straight full-sky rays at BENCH_RAY_ORDER (default 10: 12,582,912 rays),
moved to the radius of plane 3 of 8 (the search's chord assumes
|n| = wpm1), and BENCH_NGALS sources (default 100,000) at random
directions and radii in plane 3's bin, from seed 5.  One call on the first
chunk warms up, then one call on every source is timed on the host clock
(the search returns host arrays, so the time includes reading every hit
back).  BENCH_GALS_MODE: device (default, gals.gridsearch.
find_images_device), born (find_images_born) or host (find_images over
GridSearchTables); BENCH_GALS_CHUNK (16384) and BENCH_GALS_TOPK (16) set
the device search's chunk and candidates.  The last line is one JSON object,
{"metric": "gals_per_sec_gridsearch", ...}.  It runs on the GPU and fails
when there is none; --device cpu runs it on the CPU (for tests, at small
shapes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import RayTraceConfig
from ..driver import Raytracer, plane_params
from ..gals import gridsearch as gs
from ..healpix import torchhp

PLANE = 3


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m calclens_tpu_torch.tools.bench_gals")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_gals: torch sees no CUDA device (--device cpu runs it "
              "on the CPU)", file=sys.stderr)
        return 1
    ray_order = int(os.environ.get("BENCH_RAY_ORDER", 10))
    ngals = int(os.environ.get("BENCH_NGALS", 100_000))
    mode = os.environ.get("BENCH_GALS_MODE", "device")
    chunk = int(os.environ.get("BENCH_GALS_CHUNK", 16384))
    topk = int(os.environ.get("BENCH_GALS_TOPK", 16))
    if mode == "sharded":
        raise NotImplementedError(
            "the sharded search (gals.gridsearch.find_images_sharded) runs "
            "on a mesh of ranks, one process each (parallel.sharding."
            "make_mesh); this tool times one process: chip_smoke.py "
            "--phase 16 runs the sharded search")
    if mode not in ("device", "born", "host"):
        raise ValueError(f"BENCH_GALS_MODE={mode}")

    cfg = RayTraceConfig(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        SHTOrder=min(ray_order, 8), rayOrder=ray_order, bundleOrder=3,
        Precision="f32").finalize()
    rt = Raytracer(cfg, device=args.device)
    rt.init_rays()
    pp = plane_params(cfg, rt.cosmo, PLANE)
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    rt.rays_packed[0:3] *= pp.rad / (binL / 2.0)

    rng = np.random.default_rng(5)
    v = rng.normal(size=(ngals, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rad = rng.uniform(PLANE * binL + 1.0, (PLANE + 1) * binL - 1.0, ngals)
    gal_pos = v * rad[:, None]
    gal_idx = np.arange(ngals)

    if mode == "host":
        tables = gs.GridSearchTables(cfg.rayOrder)

        def run(pos, idx):
            return gs.find_images(cfg, tables, rt.rays_packed, pos, idx,
                                  pp.rad, pp.rad_minus1, chunk=4096,
                                  nest2index=tables.ring_of_nest)
    else:
        tab = torchhp.InterpTables(cfg.rayOrder)

        def run(pos, idx):
            if mode == "born":
                return gs.find_images_born(cfg, tab, rt.rays_packed, pos,
                                           idx, pp.rad, pp.rad_minus1)
            return gs.find_images_device(cfg, tab, rt.rays_packed, pos, idx,
                                         pp.rad, pp.rad_minus1, chunk=chunk,
                                         topk=topk)

    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(gal_pos[:chunk], gal_idx[:chunk])
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    images = run(gal_pos, gal_idx)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "gals_per_sec_gridsearch",
        "mode": mode,
        "value": ngals / dt,
        "unit": "gals/s",
        "ngals": ngals,
        "nrays": int(rt.rays_packed.shape[1]),
        "images_found": int(len(images.index)),
        "wall_s": dt,
        "warmup_s": warm,
        "ray_order": ray_order,
        "chunk": chunk,
        "topk": topk,
        "device": rt.device.type,
        "device_name": (torch.cuda.get_device_name(rt.device)
                        if rt.device.type == "cuda" else "cpu"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
