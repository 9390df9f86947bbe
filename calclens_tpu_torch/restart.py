"""Checkpoint / resume in the npz format (reference restart.c).

Port of the npz half of calclens_tpu/restart.py, with the same keys and the
same compatibility fields, so a restart.npz written by either package
resumes in the other.  The compatibility check validates the config fields
that change the physics or the layout (restart.c:66-124).
"""

from __future__ import annotations

import os

import numpy as np

_COMPAT_FIELDS = (
    "OmegaM", "maxComvDistance", "NumLensPlanes", "rayOrder", "bundleOrder",
    "SHTOrder", "minRa", "maxRa", "minDec", "maxDec",
)


def write_restart(path, cfg, rays, ray_nest, current_plane, map_num=0):
    """Atomic write of a host Rays view: .tmp then rename; the previous file
    is kept as .bak (restart.c:38-53)."""
    tmp = path + ".tmp"
    np.savez(
        tmp,
        n=np.asarray(rays.n), beta=np.asarray(rays.beta),
        A=np.asarray(rays.A), Aprev=np.asarray(rays.Aprev),
        alpha=np.asarray(rays.alpha), U=np.asarray(rays.U),
        phi=np.asarray(rays.phi),
        ray_nest=np.asarray(ray_nest),
        current_plane=np.int64(current_plane),
        map_num=np.int64(map_num),
        compat=np.array([float(getattr(cfg, f)) for f in _COMPAT_FIELDS]),
    )
    saved = tmp if tmp.endswith(".npz") else tmp + ".npz"
    if os.path.exists(path):
        os.replace(path, path + ".bak")
    os.replace(saved, path)


def read_restart(path, cfg, dtype=np.float32):
    """Returns (rays, ray_nest, current_plane, map_num) with rays a host
    Rays view of numpy arrays; raises on a config mismatch."""
    from .rays.propagate import Rays

    with np.load(path) as z:
        compat = z["compat"]
        want = np.array([float(getattr(cfg, f)) for f in _COMPAT_FIELDS])
        bad = np.flatnonzero(~np.isclose(compat, want))
        if len(bad):
            names = [_COMPAT_FIELDS[i] for i in bad]
            raise ValueError(f"restart incompatible with config: {names}")
        ndt = np.dtype(dtype)
        rays = Rays(
            n=np.asarray(z["n"], ndt), beta=np.asarray(z["beta"], ndt),
            A=np.asarray(z["A"], ndt), Aprev=np.asarray(z["Aprev"], ndt),
            alpha=np.asarray(z["alpha"], ndt), U=np.asarray(z["U"], ndt),
            phi=np.asarray(z["phi"], ndt),
        )
        return (rays, z["ray_nest"].copy(), int(z["current_plane"]),
                int(z["map_num"]))
