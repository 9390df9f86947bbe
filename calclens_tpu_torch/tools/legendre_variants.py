"""Design variants of the Legendre sweeps K1-K4 and of K3's seed pre-pass,
timed on the card.

    python -m calclens_tpu_torch.tools.legendre_variants [--order 12]

Each variant is the kernels' sources (csrc/) with a few lines replaced,
built into its own library under build/variants/ and loaded beside the
port's; K2, K2-4col, K1, K3's seed pre-pass, K3 (with derivatives and
without, on the table that pre-pass wrote) and K4 of every variant run on the
same inputs (random alm and ring sums from a numpy seed,
roofline_legendre._production_inputs) and the plan's ring geometry and
cutoffs, and are timed with CUDA events.
The unchanged sources also run on an all-equatorial geometry (cos theta =
0, no cutoff), where every warp is in its steady mode from the first group
on: the steady loop's own rate; and on the plan's rings without the
128-ring cutoff of K2 and K3.  Each variant's outputs are held to the
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
from ..sht import legendre as TL
from . import cuda_ms, require_cuda

# K4 with its tile contracted in FP32 FMAs on the CUDA cores instead of the
# tensor cores: the sources staged in shared memory in the stored order (S0
# re, S1 re, S0 im, S1 im), two lanes per degree, each summing half of the
# warp's 128 rings (the loop's start staggered by degree pair, for the
# banks); the tensor-core branch stays in the source, unreached
_K4_FP32_SOURCES = """    __shared__ __align__(16) float src_s[kWarps][4][kRow];
    {
      const float* src[4] = {m_even ? ere : ore, m_even ? ore : ere,
                             m_even ? eim : oim, m_even ? oim : eim};
#pragma unroll
      for (int q = 0; q < kRings; ++q) {
        const int j = jw + 32 * q + lane;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          src_s[w][r][4 * lane + q] = j < J ? src[r][mrow + j] : 0.0f;
        }
      }
    }
    int buf = 0;
"""
_K4_FP32_CONTRACTION = """          } else if (true) {
            const int dg = lane >> 1, h = lane & 1;
            const int par = (lb + dg) & 1;
            const float* lr = &lam_s[w][dg][4 * h];
            const float* sr = &src_s[w][par][4 * h];
            const float* si = &src_s[w][2 + par][4 * h];
            float pr = 0.0f, pim = 0.0f;
#pragma unroll
            for (int it = 0; it < kWarpJ / 8; ++it) {
              const int v = 8 * ((it + (dg >> 1)) & (kWarpJ / 8 - 1));
              const float4 x = *reinterpret_cast<const float4*>(lr + v);
              const float4 a = *reinterpret_cast<const float4*>(sr + v);
              const float4 b = *reinterpret_cast<const float4*>(si + v);
              pr += x.x * a.x;
              pr += x.y * a.y;
              pr += x.z * a.z;
              pr += x.w * a.w;
              pim += x.x * b.x;
              pim += x.y * b.y;
              pim += x.z * b.z;
              pim += x.w * b.w;
            }
            pr += __shfl_xor_sync(0xffffffffu, pr, 1);
            pim += __shfl_xor_sync(0xffffffffu, pim, 1);
            if (h == 0) part[buf][w][dg] = make_float2(pr, pim);
          } else {
            // the 16 degrees' sums over the warp's rings, lambda's high and
"""

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
    "K1 64 threads x 8 rings": [("legendre_analysis.cu",
                                 "constexpr int kThreads = 128;",
                                 "constexpr int kThreads = 64;"),
                                ("legendre_analysis.cu",
                                 "constexpr int kRings = 4;",
                                 "constexpr int kRings = 8;")],
    # K4 held to 102 registers, 5 resident blocks per SM (smem allows 5)
    "K4 5 blocks per SM": [("legendre_analysis_dot.cu",
                            "__launch_bounds__(kThreads)\n"
                            "legendre_analysis_dot_kernel(",
                            "__launch_bounds__(kThreads, 5)\n"
                            "legendre_analysis_dot_kernel(")],
    "K4 FP32 contraction": [
        ("legendre_analysis_dot.cu", "    int buf = 0;\n", _K4_FP32_SOURCES),
        ("legendre_analysis_dot.cu",
         "          } else {\n            // the 16 degrees' sums over the "
         "warp's rings, lambda's high and\n", _K4_FP32_CONTRACTION)],
    # K3's seed pre-pass: its producers on the plain chain_step, and more
    # resident blocks per SM (more consumers polling beside the producers)
    "seed plain-chain producers": [("legendre_synth_vpu.cu",
                                    "if (__all_sync(kFull, scaled_ok(s))) {",
                                    "if (false) {")],
    "seed 4 blocks per SM": [("legendre_synth_vpu.cu",
                              "constexpr int kSeedBlocksPerSM = 2;",
                              "constexpr int kSeedBlocksPerSM = 4;")],
    "seed 16 blocks per SM": [("legendre_synth_vpu.cu",
                               "constexpr int kSeedBlocksPerSM = 2;",
                               "constexpr int kSeedBlocksPerSM = 16;")],
}
# a variant's outputs against the built kernels', relative to their max:
# the twins' bound (a variant changes the order of the sums, or K2's cutoff
# tile, whose cut entries are below float32 significance)
REL_BOUND = 1e-5
# rings per K2 warp (its cutoff tile) of each variant
_K2_TILE = {"K2 2 rings per thread": 64}
_SIGNATURES = ("legendre_synth_launch", "legendre_synth_phi_launch",
               "legendre_analysis_launch", "legendre_chain_seed_launch",
               "legendre_synth_vpu_launch", "legendre_analysis_dot_launch")
_SOURCES = ("legendre_synth.cu", "legendre_analysis.cu",
            "legendre_synth_vpu.cu", "legendre_analysis_dot.cu")


def build(name, edits, out_dir):
    """The K1-K4 library of one variant: csrc/ copied to out_dir, edited,
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
    for src in _SOURCES:
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
    return _ext.bind(ctypes.CDLL(lib_path), _SIGNATURES), ptxas


def time_variant(lib, plan, streams, ana, geo):
    """kernel -> (ms, output) of K2, K2-4col, K1, K3's seed pre-pass, K3
    (both forms) and K4 from `lib` on ring geometry geo = (cth, ln_sth, sth,
    cot, 1/sth, K2's cutoff, K3's 128-ring cutoff, the 512-ring cutoff); K1's
    and K4's times include zeroing their output, as the wrappers' do; K3
    reads the seed table of the pre-pass's last timed launch."""
    cth, ln_sth, sth, cot, inv, mcut2, mcut3, mcut1 = geo
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
                          res.data_ptr(), nl, nm, J, 0, stream), name)
        out[name] = (cuda_ms(call, 3), res)
    seed = torch.empty((nm, J), device=dev)
    seed_k = torch.empty((nm, J), dtype=torch.int32, device=dev)
    scratch = torch.empty(TL.chain_seed_scratch(nm, J), dtype=torch.int32,
                          device=dev)

    def pre_pass():
        _ext.check(lib.legendre_chain_seed_launch(
            sth.data_ptr(), seed.data_ptr(), seed_k.data_ptr(),
            scratch.data_ptr(), scratch.numel(), nm, J, stream),
            "legendre_chain_seed")
    out["legendre_chain_seed"] = (cuda_ms(pre_pass, 3), seed)
    for name, derivs in (("legendre_synth_vpu", 1),
                         ("legendre_synth_vpu_phi", 0)):
        res = torch.empty((nm, 12 if derivs else 4, J), device=dev)

        def k3(derivs=derivs, res=res, name=name):
            _ext.check(lib.legendre_synth_vpu_launch(
                *(x.data_ptr() for x in streams[:2]), cth.data_ptr(),
                cot.data_ptr(), inv.data_ptr(), seed.data_ptr(),
                seed_k.data_ptr(), mcut3.data_ptr(), res.data_ptr(), nl, nm,
                J, derivs, 0, stream), name)
        out[name] = (cuda_ms(k3, 3), res)
    for name, fn in (("legendre_analysis", lib.legendre_analysis_launch),
                     ("legendre_analysis_dot",
                      lib.legendre_analysis_dot_launch)):
        alm = torch.zeros((2, nm, nl), device=dev)

        def ka(fn=fn, alm=alm, name=name):
            alm.zero_()
            _ext.check(fn(*(x.data_ptr() for x in ana[:4]), *g,
                          mcut1.data_ptr(), alm[0].data_ptr(),
                          alm[1].data_ptr(), nl, nm, J, 0, stream), name)
        out[name] = (cuda_ms(ka, 3), alm)
    return out


def run(order=12, device="cuda"):
    from ..sht.plan import SHTPlan
    from .roofline_legendre import _production_inputs

    dev = require_cuda(device)
    plan = SHTPlan(order, dev, dtype=torch.float32)
    streams, ana = _production_inputs(plan)
    zero = torch.zeros_like(plan.cth)
    one = torch.ones_like(plan.cth)
    rings = (plan.cth, plan.ln_sth, plan.sth, plan.cot, plan.inv_sth)

    def full(tile):
        return torch.full((-(-plan.J // tile),), plan.nm, dtype=torch.int32,
                          device=dev)

    out_root = os.path.join(os.path.dirname(_ext.BUILD_DIR), "variants")
    results, ref = {}, None
    for i, (name, edits) in enumerate(VARIANTS.items()):
        lib, ptxas = build(name, edits, os.path.join(out_root, str(i)))
        k2_tile = _K2_TILE.get(name, TL.SYNTH_TILE_J)
        geos = {"rings": (*rings, plan.mcut(k2_tile),
                          plan.mcut(TL.SYNTH_TILE_J),
                          plan.mcut(TL.ANALYSIS_TILE_J))}
        if not edits:
            geos["equator"] = (zero, zero, one, zero, one, full(k2_tile),
                               full(TL.SYNTH_TILE_J),
                               full(TL.ANALYSIS_TILE_J))
            geos["uncut"] = (*rings, full(k2_tile), full(TL.SYNTH_TILE_J),
                             plan.mcut(TL.ANALYSIS_TILE_J))
        for gname, geo in geos.items():
            got = time_variant(lib, plan, streams, ana, geo)
            if ref is None:
                ref = {k: v[1].clone() for k, v in got.items()}
            r = {k: dict(ms=ms, rel=float((res - ref[k]).abs().max()
                                          / ref[k].abs().max()))
                 for k, (ms, res) in got.items()}
            if gname == "equator":  # another function: nothing to hold
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
