"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc for Hopper (sm_90a) into one
shared library with a plain C interface, loaded with ctypes.  Every exported
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
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("legendre_analysis.cu", "legendre_synth.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launches()
launches = {"legendre_analysis": 0, "legendre_synth": 0}

# C launcher signatures: "p" = device pointer, "i" = int, "s" = cudaStream_t
_SIGNATURES = {
    # ere, eim, ore, oim, cth, ln_sth, logc, mcut, alm_re, alm_im,
    # nl, nm, J, stream
    "legendre_analysis_launch": "pppppppppp" + "iii" + "s",
    # a_re, a_im, h_re, h_im, cth, ln_sth, logc, out, nl, nm, J, stream
    "legendre_synth_launch": "pppppppp" + "iii" + "s",
}

_lib = None
build_seconds = None  # wall time of the nvcc build in this process (None: cached)


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
    return its path."""
    global build_seconds
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(SRC_DIR, s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: no process loads a partial file
    build_seconds = time.perf_counter() - t0
    return path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        codes = {"p": ctypes.c_void_p, "i": ctypes.c_int, "s": ctypes.c_void_p}
        for name, sig in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = [codes[c] for c in sig]
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str):
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
