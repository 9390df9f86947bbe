"""LGadget-2 snapshot reader (reference lgadgetio.c, for the THREEDPOT path).

The port's own copy of calclens_tpu/io/lgadget.py (numpy only), held to the
original by tests/test_torch_copies.py.

Fortran-style unformatted blocks: [i4 len][payload][i4 len].  Header is the
256-byte io_header_1 (lgadgetio.c:11-33); block 2 holds float32 positions.
npartTotal splits totals >2^32 across words 1 and 2.
"""

from __future__ import annotations

import struct

import numpy as np

_HEAD = struct.Struct("<6I6dddii6IiiddddiiI6I60s")
assert _HEAD.size == 256, _HEAD.size


def write_header(npart1, mass1, time, redshift, npart_total1, num_files,
                 boxsize, omega0, omegal, hubble):
    npart = (0, npart1, 0, 0, 0, 0)
    mass = (0.0, mass1, 0.0, 0.0, 0.0, 0.0)
    nptot = (0, npart_total1 & 0xFFFFFFFF, npart_total1 >> 32, 0, 0, 0)
    return _HEAD.pack(*npart, *mass, time, redshift, 0, 0, *nptot, 0,
                      num_files, boxsize, omega0, omegal, hubble, 0, 0, 0,
                      0, 0, 0, 0, 0, 0, b"")


def read_header(filename):
    with open(filename, "rb") as fp:
        n1 = struct.unpack("<i", fp.read(4))[0]
        raw = fp.read(256)
        fp.read(max(0, n1 - 256))
        fp.read(4)
    v = _HEAD.unpack(raw)
    npart = v[0:6]
    mass = v[6:12]
    time, redshift = v[12], v[13]
    nptot = v[16:22]
    num_files = v[23]
    boxsize, omega0, omegal, hubble = v[24], v[25], v[26], v[27]
    return dict(
        npart=npart[1], mass=mass[1] * 1e10, time=time, redshift=redshift,
        npart_total=int(nptot[1]) + (int(nptot[2]) << 32),
        num_files=num_files, boxsize=boxsize, omega0=omega0,
        omegal=omegal, hubble=hubble,
    )


def write_snapshot(filename, pos, mass1_1e10=1.0, time=1.0, boxsize=1000.0,
                   omega0=0.3, omegal=0.7, hubble=0.7, num_files=1,
                   npart_total=None):
    """Test-fixture writer for a single-file snapshot."""
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    n = len(pos)
    head = write_header(n, mass1_1e10, time, 1.0 / time - 1.0,
                        npart_total if npart_total is not None else n,
                        num_files, boxsize, omega0, omegal, hubble)
    with open(filename, "wb") as fp:
        fp.write(struct.pack("<i", 256))
        fp.write(head)
        fp.write(struct.pack("<i", 256))
        blen = 12 * n
        fp.write(struct.pack("<i", blen))
        fp.write(pos.astype("<f4").tobytes())
        fp.write(struct.pack("<i", blen))


def read_positions_f32(filename):
    """(pos [N,3] float32 as stored, header dict): the THREEDPOT deposit
    takes the file's float32 positions without a float64 host copy."""
    hd = read_header(filename)
    with open(filename, "rb") as fp:
        n1 = struct.unpack("<i", fp.read(4))[0]
        fp.seek(n1 + 4, 1)
        blen = struct.unpack("<i", fp.read(4))[0]
        pos = np.fromfile(fp, dtype="<f4", count=blen // 4).reshape(-1, 3)
    return pos, hd


def read_positions(filename):
    """(pos [N,3] float64 code units, mass [N] Msun/h)."""
    pos, hd = read_positions_f32(filename)
    return pos.astype(np.float64), np.full(len(pos), hd["mass"]), hd
