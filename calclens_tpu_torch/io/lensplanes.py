"""Indexed lens-plane HDF5 reader (h5py).

The port's own copy of the reader of calclens_tpu/io/lensplanes.py, whole
planes only.  The reference's format:
  file  <LensPlanePath>/<LensPlaneName>%04d.h5   (one per plane)
  /HEALPixOrder        long scalar: indexing order of the cells
  /NumLCPartsInPix     [npix] long: particle count per Peano-indexed cell
  /PeanoInd<I>         HDF5 table of LCParticle records for cell with peano
                       index I: fields partid (i8), px,py,pz,vx,vy,vz,mass (f4)
(reference read_lensplanes_hdf5.c:38-182).  h5py is imported only when a
plane is read: a machine without it can run every other part of the port.
"""

from __future__ import annotations

import numpy as np


def plane_filename(path: str, name: str, plane_num: int) -> str:
    return f"{path}/{name}{plane_num:04d}.h5"


def read_plane(filename):
    """Read every particle (pos [N,3] f8, mass [N] f8) of a lens-plane file."""
    import h5py

    with h5py.File(filename, "r") as f:
        counts = np.asarray(f["/NumLCPartsInPix"])
        pos_list, mass_list = [], []
        for cell in np.flatnonzero(counts):
            rec = np.asarray(f[f"PeanoInd{cell}"])
            pos_list.append(
                np.stack([rec["px"], rec["py"], rec["pz"]], axis=1).astype(np.float64)
            )
            mass_list.append(rec["mass"].astype(np.float64))
    if not pos_list:
        return np.zeros((0, 3)), np.zeros(0)
    return np.concatenate(pos_list), np.concatenate(mass_list)
