"""pixLC lens-plane reader (reference read_lensplanes_pixLC.c:13-25).

The port's own copy of the reader of calclens_tpu/io/pixlc.py, whole planes
only.  One binary file per (plane, file-cell): <path>/<name>_<plane>_<nest>,
little-endian packed:
  header (C struct, natural alignment, 72 bytes):
    u8 npart, u4 indexnside, u4 filenside, f4 rmin, f4 rmax, u8 npartrad,
    f4 boxsize, (pad) f8 mass [1e10 Msun/h], f8 omega0, f8 omegalambda,
    f8 hubbleparam
  long[12*indexnside^2] per-cell index (skipped by the reader)
  float[3*npart] positions (Mpc/h)
All particles in a file share head.mass * 1e10 Msun/h.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..healpix import core as hp

_HEADER = struct.Struct("<QIIffQf4xdddd")
HEADER_SIZE = _HEADER.size


def cell_filename(path, name, plane_num, nest):
    return os.path.join(path, f"{name}_{plane_num}_{nest}")


def read_header(filename):
    with open(filename, "rb") as fp:
        raw = fp.read(HEADER_SIZE)
    (npart, indexnside, filenside, rmin, rmax, npartrad, boxsize,
     mass, omega0, omegal, hubble) = _HEADER.unpack(raw)
    return dict(npart=npart, indexnside=indexnside, filenside=filenside,
                rmin=rmin, rmax=rmax, npartrad=npartrad, boxsize=boxsize,
                mass=mass, omega0=omega0, omegal=omegal, hubble=hubble)


def read_plane(path, name, plane_num):
    """Read every cell of one plane: (pos [N,3] f8, mass [N] f8 in Msun/h)."""
    probe = None
    for fn in os.listdir(path):
        if fn.startswith(f"{name}_{plane_num}_"):
            probe = os.path.join(path, fn)
            break
    if probe is None:
        return np.zeros((0, 3)), np.zeros(0)
    hd = read_header(probe)
    file_order = int(np.log2(hd["filenside"])) if hd["filenside"] > 1 else 0

    pos_list, mass_list = [], []
    for nest in range(int(hp.order2npix(file_order))):
        fn = cell_filename(path, name, plane_num, nest)
        if not os.path.exists(fn):
            continue
        hd = read_header(fn)
        if hd["npart"] == 0:
            continue
        with open(fn, "rb") as fp:
            fp.seek(HEADER_SIZE + 8 * 12 * hd["indexnside"] ** 2)
            pos = np.frombuffer(fp.read(12 * hd["npart"]), dtype="<f4")
        pos = pos.reshape(-1, 3).astype(np.float64)
        pos_list.append(pos)
        mass_list.append(np.full(len(pos), hd["mass"] * 1e10))
    if not pos_list:
        return np.zeros((0, 3)), np.zeros(0)
    return np.concatenate(pos_list), np.concatenate(mass_list)
