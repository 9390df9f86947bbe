"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc for Hopper (sm_90a), one
nvcc process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes.  Every exported
launcher takes device pointers, sizes and a CUDA stream, enqueues its kernel
on that stream without synchronising, and returns cudaGetLastError() as an
int; the Python wrappers raise when it is not 0.

The library lands in build/kernels/ under the repository root, named by a
hash of the sources so an edited kernel is rebuilt.  Nothing is compiled or
loaded when this module is imported.

`launches` counts kernel launches per kernel name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("legendre_analysis.cu", "legendre_analysis_dot.cu",
           "legendre_synth.cu", "legendre_synth_vpu.cu", "roofline_probe.cu",
           "gather_probe.cu", "rayside.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
launches = {"legendre_analysis": 0, "legendre_analysis_dot": 0,
            "legendre_synth": 0, "legendre_synth_phi": 0,
            "legendre_synth_vpu": 0, "legendre_synth_vpu_phi": 0,
            "legendre_chain_seed": 0, "roofline_probe": 0, "gather_rows": 0,
            "gather_lanes": 0, "gather_onehot": 0, "rayside": 0}

# C launcher signatures: "p" = device pointer, "i" = int, "l" = long long,
# "s" = cudaStream_t
_SIGNATURES = {
    # ere, eim, ore, oim, cth, ln_sth, logc, mcut, alm_re, alm_im,
    # nl, nm, J, m0 (the m of row 0), stream
    "legendre_analysis_launch": "pppppppppp" + "iiii" + "s",
    "legendre_analysis_dot_launch": "pppppppppp" + "iiii" + "s",
    # a_re, a_im, h_re, h_im, cth, ln_sth, logc, mcut, out, nl, nm, J, m0,
    # stream
    "legendre_synth_launch": "ppppppppp" + "iiii" + "s",
    # a_re, a_im, cth, ln_sth, logc, mcut, out, nl, nm, J, m0, stream
    "legendre_synth_phi_launch": "ppppppp" + "iiii" + "s",
    # a_re, a_im, cth, cot, inv_sth, seed, seed_k, mcut, out, nl, nm, J,
    # derivs, m0, stream
    "legendre_synth_vpu_launch": "ppppppppp" + "iiiii" + "s",
    # sth, seed, seed_k, scratch, scratch_ints, nm, J, stream
    "legendre_chain_seed_launch": "pppp" + "l" + "ii" + "s",
    # geo, out, rows, TJ, LB, LBLK, mode, stream
    "roofline_probe_launch": "pp" + "iiiii" + "s",
    # tab, idx, out, n, stream
    "gather_rows_launch": "ppp" + "l" + "s",
    "gather_lanes_launch": "ppp" + "l" + "s",
    "gather_onehot_launch": "ppp" + "l" + "s",
    # packed, maps7, wp, wpm1, wpm2, out, N, W, pix_base, order, born,
    # stream
    "rayside_launch": "pppppp" + "lll" + "ii" + "s",
}

_lib = None
build_seconds = None  # wall time of the nvcc build in this process (None: cached)
build_log = {}  # source -> nvcc's output (ptxas registers, spills) of that build


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           "the CUDA kernels cannot be built")
    return path


def _lib_path():
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(SRC_DIR)):  # sources and headers
        with open(os.path.join(SRC_DIR, name), "rb") as fp:
            h.update(name.encode() + fp.read())
    return os.path.join(BUILD_DIR, f"libcalclens_kernels_{h.hexdigest()[:16]}.so")


def build():
    """Compile csrc/*.cu into the shared library (if not already built) and
    return its path.  Each source compiles in its own nvcc process, all at
    once; the objects are then linked."""
    global build_seconds
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in SOURCES:
            obj = os.path.join(tmpdir, src + ".o")
            log = open(os.path.join(tmpdir, src + ".log"), "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(SRC_DIR, src),
                   "-o", obj]
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for (cmd, _, log, proc), src in zip(jobs, SOURCES):
            code = proc.wait()
            log.seek(0)
            build_log[src] = log.read()
            log.close()
            if code != 0:
                failed.append(f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                              f"{build_log[src]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmpdir, os.path.basename(path))
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic: no process loads a partial file
    build_seconds = time.perf_counter() - t0
    return path


def bind(handle, names=None):
    """Declare the C launchers `names` (all of them by default) of a loaded
    library from their signatures; returns the handle."""
    codes = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "l": ctypes.c_longlong, "s": ctypes.c_void_p}
    for name in names or _SIGNATURES:
        fn = getattr(handle, name)
        fn.argtypes = [codes[c] for c in _SIGNATURES[name]]
        fn.restype = ctypes.c_int
    return handle


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def check(code: int, name: str):
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def launch(name, symbol, device, *args):
    """Enqueue the C launcher `symbol` on the device's current stream (the
    library is built at the first launch); count the launch under
    `name`."""
    import torch

    fn = getattr(lib(), symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    check(code, name)
    launches[name] += 1
