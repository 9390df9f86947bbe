"""Pluggable lightcone readers for the lens-plane maker.

The reference dispatches on LightConeFileType in {ARTLC, GADGET2, LGADGET}
(lensplanes/lightconeio.c:11-42); this module provides all three as chunk
iterators compatible with lensplane_maker.make_lensplanes (vectorized numpy
reads instead of the reference's per-particle staged buffers):

  * GADGET2  — Fortran-record snapshot: 256-byte header (npart[6], mass[6],
    time, redshift, flags, npartTotal[6], num_files, BoxSize, Omega0,
    OmegaLambda, HubbleParam), then Np*3 f32 positions and Np*3 f32
    velocities (lightconeio.c:201-245).  Per-type masses come from
    header.mass with the npart[k] cumulative limits (masslims,
    lightconeio.c:305-330); units convert by MassConvFact/LengthConvFact.
  * LGADGET  — same record layout with the extended L-Gadget2 header
    (hashtabsize + npartTotalHighWord, lightconeio.c:44-95); delegates the
    header parse to io.lgadget.
  * ARTLC    — int32 particle count, then packed per-particle records of
    [i32 partid, 9 x f32] of which floats 0-5 are position/velocity
    (lightconeio.c:356-401); every particle carries cfg.partMass and no
    unit conversion is applied (matching the reference).

Synthetic writers for each format support round-trip tests.

The port's own copy of calclens_tpu/io/lightcone.py (numpy only), held to
the original by tests/test_torch_copies.py.
"""

from __future__ import annotations

import struct

import numpy as np

# GADGET2 io_header_1 (lightconeio.c:203-219): fill pads to 256 bytes
_G2_HEAD = struct.Struct("<6I6dddii6Iiidddd96s")
assert _G2_HEAD.size == 256, _G2_HEAD.size

_ART_REC = np.dtype([("partid", "<i4"), ("f", "<f4", (9,))])


# ---------------------------------------------------------------------------
# GADGET2
# ---------------------------------------------------------------------------

def read_gadget2(filename):
    """(pos [N,3] f64 code units, vel [N,3] f64 gadget units, mass [N] code
    units, header dict).  Velocities are raw (the sqrt(a) factor is applied
    by the chunk iterator, matching lightconeio.c:297,335-339)."""
    with open(filename, "rb") as fp:
        n1 = struct.unpack("<i", fp.read(4))[0]
        raw = fp.read(256)
        fp.read(max(0, n1 - 256))
        fp.read(4)
        v = _G2_HEAD.unpack(raw)
        npart = v[0:6]
        massarr = v[6:12]
        hd = dict(npart=npart, mass=massarr, time=v[12], redshift=v[13],
                  npart_total=v[16:22], num_files=v[23], boxsize=v[24],
                  omega0=v[25], omegal=v[26], hubble=v[27])
        n = int(sum(npart))
        blen = struct.unpack("<i", fp.read(4))[0]
        assert blen == 12 * n, (blen, n)
        pos = np.frombuffer(fp.read(blen), dtype="<f4").reshape(n, 3)
        fp.read(4)
        blen = struct.unpack("<i", fp.read(4))[0]
        assert blen == 12 * n, (blen, n)
        vel = np.frombuffer(fp.read(blen), dtype="<f4").reshape(n, 3)

    # per-type mass via cumulative npart limits (lightconeio.c:305-330)
    mass = np.empty(n, np.float64)
    lo = 0
    for k in range(6):
        hi = lo + int(npart[k])
        mass[lo:hi] = massarr[k]
        lo = hi
    return pos.astype(np.float64), vel.astype(np.float64), mass, hd


def write_gadget2(filename, pos, vel=None, mass_by_type=None, npart_by_type=None,
                  time=1.0, boxsize=1000.0, omega0=0.3, omegal=0.7,
                  hubble=0.7, num_files=1):
    """Synthetic single-file GADGET2 lightcone writer (test fixture)."""
    pos = np.asarray(pos, "<f4").reshape(-1, 3)
    n = len(pos)
    vel = (np.zeros_like(pos) if vel is None
           else np.asarray(vel, "<f4").reshape(-1, 3))
    if npart_by_type is None:
        npart_by_type = (0, n, 0, 0, 0, 0)
    if mass_by_type is None:
        mass_by_type = (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    assert sum(npart_by_type) == n
    head = _G2_HEAD.pack(*npart_by_type, *mass_by_type,
                         time, 1.0 / time - 1.0, 0, 0, *npart_by_type, 0,
                         num_files, boxsize, omega0, omegal, hubble, b"")
    with open(filename, "wb") as fp:
        fp.write(struct.pack("<i", 256)); fp.write(head)
        fp.write(struct.pack("<i", 256))
        blen = 12 * n
        fp.write(struct.pack("<i", blen)); fp.write(pos.tobytes())
        fp.write(struct.pack("<i", blen))
        fp.write(struct.pack("<i", blen)); fp.write(vel.tobytes())
        fp.write(struct.pack("<i", blen))


# ---------------------------------------------------------------------------
# ARTLC
# ---------------------------------------------------------------------------

def read_artlc(filename):
    """(partid [N] i64, pos [N,3] f64, vel [N,3] f64).  Raw units — the
    reference applies no conversion factors on this path."""
    with open(filename, "rb") as fp:
        n = struct.unpack("<i", fp.read(4))[0]
        rec = np.frombuffer(fp.read(n * _ART_REC.itemsize), dtype=_ART_REC)
    f = rec["f"].astype(np.float64)
    return rec["partid"].astype(np.int64), f[:, 0:3], f[:, 3:6]


def write_artlc(filename, pos, vel=None, partid=None):
    """Synthetic ARTLC lightcone writer (test fixture); the trailing three
    floats of each on-disk record are zero (the reference skips them)."""
    pos = np.asarray(pos, np.float64).reshape(-1, 3)
    n = len(pos)
    rec = np.zeros(n, dtype=_ART_REC)
    rec["partid"] = np.arange(n) if partid is None else partid
    rec["f"][:, 0:3] = pos
    if vel is not None:
        rec["f"][:, 3:6] = np.asarray(vel).reshape(-1, 3)
    with open(filename, "wb") as fp:
        fp.write(struct.pack("<i", n))
        fp.write(rec.tobytes())


# ---------------------------------------------------------------------------
# chunk iterators (maker input; unit conversion matches lightconeio.c).
# Conversion happens HERE, as in the reference readers — pass mass_conv =
# length_conv = 1.0 to make_lensplanes when feeding it these iterators.
# ---------------------------------------------------------------------------

def gadget2_chunks(paths, mass_conv=1.0, length_conv=1.0, chunk=1 << 20):
    """(pos, mass) chunks from GADGET2 lightcone files, units converted."""
    for p in paths:
        pos, _vel, mass, _hd = read_gadget2(p)
        pos = pos * length_conv
        mass = mass * mass_conv
        for i0 in range(0, len(pos), chunk):
            yield pos[i0: i0 + chunk], mass[i0: i0 + chunk]


def artlc_chunks(paths, part_mass, chunk=1 << 20):
    """(pos, mass) chunks from ARTLC files; every particle has part_mass."""
    for p in paths:
        _pid, pos, _vel = read_artlc(p)
        for i0 in range(0, len(pos), chunk):
            yield pos[i0: i0 + chunk], np.full(
                len(pos[i0: i0 + chunk]), part_mass)


def lightcone_chunks(file_type, paths, mass_conv=1.0, length_conv=1.0,
                     part_mass=0.0, chunk=1 << 20):
    """Dispatch on LightConeFileType (lightconeio.c:11-42)."""
    t = file_type.upper()
    if t == "GADGET2":
        return gadget2_chunks(paths, mass_conv, length_conv, chunk)
    if t == "ARTLC":
        return artlc_chunks(paths, part_mass, chunk)
    if t == "LGADGET":
        from ..lensplane_maker import lgadget_chunks

        def conv():
            for pos, mass in lgadget_chunks(paths, chunk):
                yield pos * length_conv, mass * mass_conv

        return conv()
    raise ValueError(f"unknown LightConeFileType {file_type!r} "
                     "(expected ARTLC, GADGET2 or LGADGET)")
