"""Seconds, GB/s and memory peaks of the port's two restart routes on one
device, on a full-sky ray buffer:

    python -m calclens_tpu_torch.tools.bench_restart [--ray-order 12]
        [--device cuda|cpu] [--dir DIR]

Raytracer.init_rays at --ray-order (default 12: 201,326,592 rays, a
16.9 GB float32 buffer; SHTOrder 6, whose plan is built and not used),
then each route once, timed between two device syncs: save_restart_sharded
(the checkpoint run() writes), load_restart_sharded into a second
Raytracer, save_restart (the npz file, the format the JAX package reads)
and load_restart.  Each load must give the buffer bit for bit.  The files
go to a temporary directory under DIR (the system's by default) and are
removed at the end; the loads read files just written, so they find them
in the page cache (warm).  The last line is one JSON object, {"metric":
"restart_routes", ...}.  It runs on the GPU and fails when there is none;
--device cpu runs it on the CPU (for tests, at small orders: the card's
fields are then null).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import threading
import time

import torch

from ..config import RayTraceConfig
from ..driver import Raytracer

SHT_ORDER = 6
ROUTES = ("sharded_write", "sharded_load", "npz_write", "npz_load")


def rss_bytes():
    """This process's resident set now (/proc/self/statm)."""
    with open("/proc/self/statm") as fp:
        return int(fp.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def measured(fn, nbytes, device="cuda"):
    """fn() once, between two syncs of `device`: (its value, {s, gbps:
    nbytes over s, card_peak: the card's peak allocation during it,
    card_rise: that peak over what was allocated before, host_peak and
    host_rise: the same of this process's resident set, sampled every 5
    ms, maxrss: resource.getrusage's ru_maxrss after it}), in bytes; the
    card's fields are None on the CPU."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        card0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    rss0 = rss_bytes()
    peak = [rss0]
    done = threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], rss_bytes())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        done.set()
        sampler.join()
    host = max(peak[0], rss_bytes())
    card = torch.cuda.max_memory_allocated() if cuda else None
    return out, dict(s=secs, gbps=nbytes / secs / 1e9, card_peak=card,
                     card_rise=None if card is None else card - card0,
                     host_peak=host, host_rise=host - rss0,
                     maxrss=resource.getrusage(
                         resource.RUSAGE_SELF).ru_maxrss * 1024)


def route_text(label, m):
    """One measured() route as text."""
    card = ("" if m["card_peak"] is None else
            f"card peak {m['card_peak'] / 2**30:.2f} GiB "
            f"(+{m['card_rise'] / 2**30:.3f}), ")
    return (f"{label} {m['s']:.3f} s = {m['gbps']:.3f} GB/s, {card}host RSS "
            f"peak {m['host_peak'] / 2**30:.2f} GiB "
            f"(+{m['host_rise'] / 2**30:.3f}), ru_maxrss "
            f"{m['maxrss'] / 2**30:.2f} GiB")


def routes(rt, npz, device, sharded_write=None):
    """The four routes on rt's state, {route: measured()}, and the bytes
    each format takes on disk: save_restart_sharded to
    rt.sharded_restart_path() (or sharded_write, the measurement of a
    checkpoint already written there), load_restart_sharded into a new
    Raytracer, save_restart and load_restart through `npz`.  Raises when a
    load does not give rt's buffer and plane bit for bit."""
    nbytes = rt.rays_packed.numel() * rt.rays_packed.element_size()
    out = {"sharded_write": sharded_write or measured(
        rt.save_restart_sharded, nbytes, device)[1]}
    back = Raytracer(rt.cfg, device=device)
    for fmt, save, load in (
            ("sharded", None, back.load_restart_sharded),
            ("npz", lambda: rt.save_restart(npz),
             lambda: back.load_restart(npz))):
        if save is not None:
            out[f"{fmt}_write"] = measured(save, nbytes, device)[1]
        out[f"{fmt}_load"] = measured(load, nbytes, device)[1]
        if not (torch.equal(back.rays_packed, rt.rays_packed)
                and back.current_plane == rt.current_plane):
            raise RuntimeError(f"load of the {fmt} restart: not the saved "
                               f"rays")
        back.rays_packed = None
    ck = rt.sharded_restart_path()
    out["disk"] = dict(sharded=sum(os.path.getsize(os.path.join(ck, f))
                                   for f in os.listdir(ck)),
                       npz=os.path.getsize(npz))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m calclens_tpu_torch.tools.bench_restart")
    ap.add_argument("--ray-order", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_restart: torch sees no CUDA device (--device cpu runs "
              "it on the CPU)", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0,
                             NumLensPlanes=8, SHTOrder=SHT_ORDER,
                             rayOrder=args.ray_order, bundleOrder=3,
                             Precision="f32", OutputPath=tmp).finalize()
        rt = Raytracer(cfg, device=args.device)
        rt.init_rays()
        rt.current_plane = 3
        res = routes(rt, os.path.join(tmp, "restart.npz"), args.device)
        nbytes = rt.rays_packed.numel() * rt.rays_packed.element_size()
    device = (torch.cuda.get_device_name(0) if args.device == "cuda"
              else "cpu")
    for key in ROUTES:
        print(route_text(key, res[key]))
    print(json.dumps(dict(metric="restart_routes", device=device,
                          ray_order=args.ray_order, bytes=nbytes, **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
