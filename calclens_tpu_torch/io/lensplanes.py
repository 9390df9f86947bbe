"""Indexed lens-plane HDF5 format: reader + writer (h5py).

The port's own copy of calclens_tpu/io/lensplanes.py, held to the original
by tests/test_torch_copies.py.  h5py is imported only when a plane is read
or written: a machine without it can run every other part of the port.

Byte-compatible with the reference's format so existing BYOLC lightcone
pipelines drop in unchanged:
  file  <LensPlanePath>/<LensPlaneName>%04d.h5   (one per plane)
  /HEALPixOrder        long scalar: indexing order of the cells
  /NumLCPartsInPix     [npix] long: particle count per Peano-indexed cell
  /PeanoInd<I>         HDF5 table of LCParticle records for cell with peano
                       index I: fields partid (i8), px,py,pz,vx,vy,vz,mass (f4)
(reference read_lensplanes_hdf5.c:38-182, make_lensplanes_hdf5.c:139-300).
"""

from __future__ import annotations

import numpy as np

from ..healpix import core as hp

LCPARTICLE_DTYPE = np.dtype([
    ("partid", "<i8"),
    ("px", "<f4"), ("py", "<f4"), ("pz", "<f4"),
    ("vx", "<f4"), ("vy", "<f4"), ("vz", "<f4"),
    ("mass", "<f4"),
])


def plane_filename(path: str, name: str, plane_num: int) -> str:
    return f"{path}/{name}{plane_num:04d}.h5"


def write_plane(filename, healpix_order, pos, mass, vel=None, partid=None):
    """Write one lens plane.  pos [N,3] comoving Mpc/h, mass [N] Msun/h."""
    pos = np.asarray(pos, dtype=np.float64).reshape(-1, 3)
    N = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, dtype=np.float64), (N,))
    vel = np.zeros((N, 3)) if vel is None else np.asarray(vel).reshape(-1, 3)
    partid = np.arange(N, dtype=np.int64) if partid is None else np.asarray(partid)

    npix = int(hp.order2npix(healpix_order))
    nest = hp.vec2pix_nest(pos, healpix_order)
    peano = hp.nest2peano(nest, healpix_order)
    counts = np.bincount(peano, minlength=npix).astype(np.int64)

    order_sort = np.argsort(peano, kind="stable")
    import h5py

    with h5py.File(filename, "w") as f:
        f.create_dataset("/HEALPixOrder", data=np.int64(healpix_order))
        f.create_dataset("/NumLCPartsInPix", data=counts)
        start = 0
        sorted_peano = peano[order_sort]
        boundaries = np.flatnonzero(np.diff(sorted_peano)) + 1
        for chunk in np.split(order_sort, boundaries):
            if len(chunk) == 0:
                continue
            cell = peano[chunk[0]]
            rec = np.zeros(len(chunk), dtype=LCPARTICLE_DTYPE)
            rec["partid"] = partid[chunk]
            rec["px"] = pos[chunk, 0]
            rec["py"] = pos[chunk, 1]
            rec["pz"] = pos[chunk, 2]
            rec["vx"] = vel[chunk, 0]
            rec["vy"] = vel[chunk, 1]
            rec["vz"] = vel[chunk, 2]
            rec["mass"] = mass[chunk]
            f.create_dataset(f"PeanoInd{cell}", data=rec)


def read_plane(filename, peano_cells=None, read_order=None):
    """Read particles (pos [N,3] f8, mass [N] f8) from a lens-plane file.

    peano_cells : optional iterable of peano indices AT read_order; when the
        file's cell order is coarser/finer the overlap logic of
        read_lensplanes_hdf5.c:38-182 applies (cull file cells to requested).
        None reads everything.
    """
    import h5py

    with h5py.File(filename, "r") as f:
        file_order = int(np.asarray(f["/HEALPixOrder"]))
        counts = np.asarray(f["/NumLCPartsInPix"])
        want = None
        if peano_cells is not None:
            read_order = file_order if read_order is None else int(read_order)
            want = _file_cells_for(peano_cells, read_order, file_order)
        pos_list, mass_list = [], []
        for cell in np.flatnonzero(counts):
            if want is not None and cell not in want:
                continue
            rec = np.asarray(f[f"PeanoInd{cell}"])
            pos_list.append(
                np.stack([rec["px"], rec["py"], rec["pz"]], axis=1).astype(np.float64)
            )
            mass_list.append(rec["mass"].astype(np.float64))
    if not pos_list:
        return np.zeros((0, 3)), np.zeros(0)
    return np.concatenate(pos_list), np.concatenate(mass_list)


def _file_cells_for(peano_cells, read_order, file_order):
    """Set of file-order peano cells overlapping the requested read-order
    cells (ioutils.c getPeanoIndsToReadFromFile semantics)."""
    cells = np.asarray(list(peano_cells), dtype=np.int64)
    if file_order == read_order:
        return set(cells.tolist())
    nest = hp.peano2nest(cells, read_order)
    if file_order < read_order:
        nf = nest >> (2 * (read_order - file_order))
        return set(hp.nest2peano(np.unique(nf), file_order).tolist())
    shift = 2 * (file_order - read_order)
    out = []
    for n in nest:
        children = (n << shift) + np.arange(1 << shift, dtype=np.int64)
        out.append(hp.nest2peano(children, file_order))
    return set(np.concatenate(out).tolist())
