"""Precomputed HEALPix lens-plane mass maps (UseHEALPixLensPlaneMaps path,
reference shtpoissonsolve.c:336-436).

The port's copy of calclens_tpu/io/healpix_maps.py (held to it by
tests/test_torch_copies.py).  File <path>/<name>.<planeNum>: raw float32
full-sky map in RING pixel order (counts; multiplied by partMass to get
mass per pixel).
"""

from __future__ import annotations

import os

import numpy as np


def map_filename(path, name, plane_num):
    return os.path.join(path, f"{name}.{plane_num}")


def read_plane_map(path, name, plane_num, npix):
    fn = map_filename(path, name, plane_num)
    m = np.fromfile(fn, dtype="<f4")
    if len(m) != npix:
        raise ValueError(f"{fn}: {len(m)} pixels, expected {npix}")
    return m


def write_plane_map(path, name, plane_num, counts):
    os.makedirs(path, exist_ok=True)
    np.asarray(counts, "<f4").tofile(map_filename(path, name, plane_num))
