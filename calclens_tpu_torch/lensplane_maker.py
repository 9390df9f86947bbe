"""Lens-plane maker (reference lensplanes/: make_lensplanes_hdf5.c,
lightconeio.c).

Streams lightcone particle chunks, converts units (MassConvFact /
LengthConvFact), bins by comoving radius into NumLensPlanes shells and by
HEALPix cell at LensPlaneOrder, and appends to the indexed HDF5 plane format
(io/lensplanes.py) using resizable datasets — the memory-buffered flush of
makeRayTracingPlanesHDF5 (make_lensplanes_hdf5.c:17-324) without its global
buffer bookkeeping.

Readers: LGadget lightcone files (io/lgadget.py) or any iterable of
(pos [N,3], mass [N]) chunks (the pluggable-reader analog of
lightconeio.c:11-33).

The port's own copy of calclens_tpu/lensplane_maker.py, held to the
original by tests/test_torch_copies.py.  h5py is imported when plane files
are written, so the module imports on a machine without it.
"""

from __future__ import annotations

import os

import numpy as np

from .healpix import core as hp
from .io.lensplanes import LCPARTICLE_DTYPE, plane_filename


def lgadget_chunks(paths, chunk=1 << 20):
    """Yield (pos, mass) chunks from LGadget lightcone files."""
    from .io import lgadget

    for p in paths:
        pos, mass, _ = lgadget.read_positions(p)
        for i0 in range(0, len(pos), chunk):
            yield pos[i0: i0 + chunk], mass[i0: i0 + chunk]


class PlaneWriter:
    """Appendable indexed-HDF5 plane files."""

    def __init__(self, path, name, num_planes, order):
        import h5py

        os.makedirs(path, exist_ok=True)
        self.order = order
        self.npix = int(hp.order2npix(order))
        self.files = []
        self.counts = []
        for p in range(num_planes):
            f = h5py.File(plane_filename(path, name, p), "w")
            f.create_dataset("/HEALPixOrder", data=np.int64(order))
            self.files.append(f)
            self.counts.append(np.zeros(self.npix, dtype=np.int64))

    def append(self, plane, peano, rec):
        f = self.files[plane]
        for cell in np.unique(peano):
            sel = peano == cell
            chunk = rec[sel]
            key = f"PeanoInd{cell}"
            if key in f:
                ds = f[key]
                n0 = ds.shape[0]
                ds.resize((n0 + len(chunk),))
                ds[n0:] = chunk
            else:
                f.create_dataset(key, data=chunk, maxshape=(None,),
                                 chunks=(max(1, min(len(chunk), 65536)),))
            self.counts[plane][cell] += len(chunk)

    def close(self):
        for f, cnt in zip(self.files, self.counts):
            f.create_dataset("/NumLCPartsInPix", data=cnt)
            f.close()


def make_lensplanes(chunks, out_path, name, num_planes, max_comv_distance,
                    lens_plane_order, mass_conv=1.0, length_conv=1.0,
                    partid_start=0):
    """Build all plane files from an iterable of (pos, mass) chunks.

    Returns per-plane particle counts.
    """
    binL = max_comv_distance / num_planes
    writer = PlaneWriter(out_path, name, num_planes, lens_plane_order)
    next_id = partid_start
    try:
        for pos, mass in chunks:
            pos = np.asarray(pos, np.float64) * length_conv
            mass = np.asarray(mass, np.float64) * mass_conv
            rad = np.linalg.norm(pos, axis=1)
            plane = (rad / binL).astype(np.int64)
            keep = (plane >= 0) & (plane < num_planes)
            at_edge = (plane == num_planes) & (np.abs(rad - max_comv_distance) < 1e-3)
            plane = np.where(at_edge, num_planes - 1, plane)
            keep |= at_edge
            pos, mass, plane = pos[keep], mass[keep], plane[keep]

            nest = hp.vec2pix_nest(pos, lens_plane_order)
            peano = hp.nest2peano(nest, lens_plane_order)
            rec = np.zeros(len(pos), dtype=LCPARTICLE_DTYPE)
            rec["partid"] = next_id + np.arange(len(pos))
            next_id += len(pos)
            rec["px"], rec["py"], rec["pz"] = pos[:, 0], pos[:, 1], pos[:, 2]
            rec["mass"] = mass
            for p in np.unique(plane):
                sel = plane == p
                writer.append(int(p), peano[sel], rec[sel])
    finally:
        counts = [c.sum() for c in writer.counts]
        writer.close()
    return counts


def make_debug_maps(path, name, num_planes, map_order=10):
    """Per-plane density maps for visual validation (reference makemaps.c:17,
    lensplanes/main.c:80-83).  Returns [num_planes, npix] nest-ordered
    surface-mass maps."""
    from .io.lensplanes import read_plane

    npix = int(hp.order2npix(map_order))
    maps = np.zeros((num_planes, npix))
    for p in range(num_planes):
        pos, mass = read_plane(plane_filename(path, name, p))
        if len(pos):
            pix = hp.vec2pix_nest(pos, map_order)
            np.add.at(maps[p], pix, mass)
    return maps
