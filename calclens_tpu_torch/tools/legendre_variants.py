"""Design variants of the Legendre sweeps K1 and K2, timed on the card.

    python -m calclens_tpu_torch.tools.legendre_variants [--order 12]

Each variant is the kernels' sources (csrc/) with a few lines replaced,
built into its own library under build/variants/ and loaded beside the
port's; K2, K2-4col and K1 of every variant run on the same inputs (random
alm and ring sums from a numpy seed, roofline_legendre._production_inputs)
and the plan's ring geometry and cutoffs, and are timed with CUDA events.
The unchanged sources also run on an all-equatorial geometry (cos theta =
0, no cutoff), where every warp is in its steady mode from the first group
on: the steady loop's own rate.  Each variant's outputs are held to the
unchanged kernels' (max |difference| / max |unchanged| <= REL_BOUND), and a
variant that computes another function raises.  The last line printed is
a JSON object of every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import torch

from .. import _ext
from . import cuda_ms, require_cuda

# name -> [(source, text, replacement)]
VARIANTS = {
    "as built": [],
    "no zero mode": [("legendre_common.cuh",
                      "return __all_sync(0xffffffffu, zero) ? Mode::kZero "
                      ": Mode::kCareful;", "return Mode::kCareful;")],
    "K2 2 rings per thread": [("legendre_synth.cu",
                               "constexpr int kRings = 4;",
                               "constexpr int kRings = 2;")],
    "K2-16 16-degree groups": [("legendre_synth.cu",
                                "kGroup = kStreams == 8 ? 8 : 16;",
                                "kGroup = 16;")],
    "K1 8-degree groups": [("legendre_analysis.cu",
                            "constexpr int kGroup = kRedL;",
                            "constexpr int kGroup = 8;")],
    "K1 64 threads x 8 rings": [("legendre_analysis.cu",
                                 "constexpr int kThreads = 128;",
                                 "constexpr int kThreads = 64;"),
                                ("legendre_analysis.cu",
                                 "constexpr int kRings = 4;",
                                 "constexpr int kRings = 8;")],
}
# a variant's outputs against the built kernels', relative to their max:
# the twins' bound (a variant changes the order of the sums, or K2's cutoff
# tile, whose cut entries are below float32 significance)
REL_BOUND = 1e-5
# rings per K2 warp (its cutoff tile) of each variant
_K2_TILE = {"K2 2 rings per thread": 64}
_SIGNATURES = ("legendre_synth_launch", "legendre_synth_phi_launch",
               "legendre_analysis_launch")


def build(name, edits, out_dir):
    """The K1/K2 library of one variant: csrc/ copied to out_dir, edited,
    one nvcc per source as _ext builds.  Returns (ctypes library, {SASS
    function: ptxas' register line})."""
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_ext.SRC_DIR, out_dir)
    for src, text, new in edits:
        path = os.path.join(out_dir, src)
        with open(path) as fp:
            code = fp.read()
        if code.count(text) != 1:
            raise RuntimeError(f"variant {name!r}: {text!r} is not once in "
                               f"{src}")
        with open(path, "w") as fp:
            fp.write(code.replace(text, new))
    nvcc = _ext._nvcc()
    objs, procs = [], []
    for src in ("legendre_synth.cu", "legendre_analysis.cu"):
        obj = os.path.join(out_dir, src + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_ext.NVCC_FLAGS, "-c", os.path.join(out_dir, src), "-o",
             obj], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    ptxas, func = {}, None
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "Function properties for" in line:
                func = line.split()[-1]
            elif "registers" in line:
                ptxas[func] = line.split(":", 1)[-1].strip()
    lib_path = os.path.join(out_dir, "libvariant.so")
    subprocess.run([nvcc, "-shared", "-o", lib_path, *objs], check=True)
    lib = ctypes.CDLL(lib_path)
    for fn in _SIGNATURES:
        sig = _ext._SIGNATURES[fn]
        getattr(lib, fn).argtypes = [ctypes.c_int if c == "i"
                                     else ctypes.c_void_p for c in sig]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, ptxas


def time_variant(lib, plan, streams, ana, geo):
    """kernel -> (ms, output) of K2, K2-4col and K1 from `lib` on ring
    geometry geo = (cth, ln_sth, K2 cutoff, K1 cutoff); K1's time includes
    zeroing its output, as analysis_cuda's does."""
    cth, ln_sth, mcut2, mcut1 = geo
    nl, nm, J = plan.nl, plan.nm, plan.J
    dev = plan.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = (cth.data_ptr(), ln_sth.data_ptr(), plan.logc.data_ptr())
    out = {}
    for name, ss, fn in (("legendre_synth", streams,
                          lib.legendre_synth_launch),
                         ("legendre_synth_phi", streams[:2],
                          lib.legendre_synth_phi_launch)):
        res = torch.empty((nm, 4 * len(ss), J), device=dev)

        def call(ss=ss, fn=fn, res=res):
            _ext.check(fn(*(x.data_ptr() for x in ss), *g, mcut2.data_ptr(),
                          res.data_ptr(), nl, nm, J, stream), name)
        out[name] = (cuda_ms(call, 3), res)
    alm = torch.zeros((2, nm, nl), device=dev)

    def k1():
        alm.zero_()
        _ext.check(lib.legendre_analysis_launch(
            *(x.data_ptr() for x in ana[:4]), *g, mcut1.data_ptr(),
            alm[0].data_ptr(), alm[1].data_ptr(), nl, nm, J, stream),
            "legendre_analysis")
    out["legendre_analysis"] = (cuda_ms(k1, 3), alm)
    return out


def run(order=12, device="cuda"):
    from ..sht import legendre as TL
    from ..sht.plan import SHTPlan
    from .roofline_legendre import _production_inputs

    dev = require_cuda(device)
    plan = SHTPlan(order, dev, dtype=torch.float32)
    streams, ana = _production_inputs(plan)
    zero = torch.zeros_like(plan.cth)

    def full(tile):
        return torch.full((-(-plan.J // tile),), plan.nm, dtype=torch.int32,
                          device=dev)

    out_root = os.path.join(os.path.dirname(_ext.BUILD_DIR), "variants")
    results, ref = {}, None
    for i, (name, edits) in enumerate(VARIANTS.items()):
        lib, ptxas = build(name, edits, os.path.join(out_root, str(i)))
        k2_tile = _K2_TILE.get(name, TL.SYNTH_TILE_J)
        geos = {"rings": (plan.cth, plan.ln_sth, plan.mcut(k2_tile),
                          plan.mcut(TL.ANALYSIS_TILE_J))}
        if not edits:
            geos["equator"] = (zero, zero, full(k2_tile),
                               full(TL.ANALYSIS_TILE_J))
        for gname, geo in geos.items():
            got = time_variant(lib, plan, streams, ana, geo)
            if ref is None:
                ref = {k: v[1].clone() for k, v in got.items()}
            r = {k: dict(ms=ms, rel=float((res - ref[k]).abs().max()
                                          / ref[k].abs().max()))
                 for k, (ms, res) in got.items()}
            if gname == "equator":
                r = {k: dict(ms=v["ms"]) for k, v in r.items()}
            elif max(v["rel"] for v in r.values()) > REL_BOUND:
                raise RuntimeError(f"variant {name!r} computes another "
                                   f"function: {r}")
            results[f"{name} | {gname}"] = dict(kernels=r, ptxas=ptxas)
            print(f"{name:26s} {gname:8s} " + ", ".join(
                f"{k} {v['ms']:.2f} ms" for k, v in r.items()), flush=True)
            del got
        torch.cuda.empty_cache()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m calclens_tpu_torch.tools.legendre_variants")
    ap.add_argument("--order", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.order, args.device)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          order=args.order, variants=res)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
