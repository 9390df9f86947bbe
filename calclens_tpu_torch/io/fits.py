"""Minimal pure-numpy FITS reader (no cfitsio/astropy dependency).

The port's own copy of the reader half of calclens_tpu/io/fits.py: primary
image HDUs and binary-table extensions, per the FITS 4.0 standard (80-byte
cards, 2880-byte blocks, big-endian data).  The port reads the HEALPix ring
weights and pixel windows with it (io/weights.py).
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80

_TFORM2DTYPE = {
    "L": ">i1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8",
}
_BITPIX2DTYPE = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}


def _parse_header(raw):
    hdr = {}
    order = []
    for off in range(0, len(raw), CARD):
        card = raw[off: off + CARD].decode("ascii", "replace")
        key = card[:8].strip()
        if key == "END":
            break
        if key in ("COMMENT", "HISTORY", ""):
            continue
        if key == "HIERARCH":
            body = card[9:]
            eq = body.find("= ")
            if eq < 0:
                continue
            key = body[:eq].strip()
            val = body[eq + 2:].split("/")[0].strip()
        elif card[8:10] == "= ":
            val = card[10:].split("/")[0].strip()
        else:
            continue
        if val.startswith("'"):
            v = val.strip("'").strip()
        elif val == "T":
            v = True
        elif val == "F":
            v = False
        else:
            try:
                v = int(val)
            except ValueError:
                v = float(val)
        hdr[key] = v
        order.append(key)
    hdr["_order"] = order
    return hdr


def read_fits(filename):
    """Returns list of (header dict, data) — ndarray for images, structured
    array for bintables."""
    out = []
    with open(filename, "rb") as fp:
        buf = fp.read()
    pos = 0
    while pos < len(buf):
        # read header blocks until END card
        hstart = pos
        while True:
            block = buf[pos: pos + BLOCK]
            pos += BLOCK
            if b"END" in block and _has_end(block):
                break
            if pos >= len(buf):
                raise ValueError("FITS: unterminated header")
        hdr = _parse_header(buf[hstart:pos])
        if hdr.get("XTENSION", "").startswith("BINTABLE"):
            nrow = hdr["NAXIS2"]
            rowb = hdr["NAXIS1"]
            fields = []
            for i in range(1, hdr["TFIELDS"] + 1):
                tf = str(hdr[f"TFORM{i}"]).strip()
                reps = int(tf[:-1]) if len(tf) > 1 else 1
                dt = _TFORM2DTYPE[tf[-1]]
                nm = str(hdr[f"TTYPE{i}"]).strip()
                fields.append((nm, dt, (reps,)) if reps != 1 else (nm, dt))
            dtype = np.dtype(fields)
            if dtype.itemsize != rowb:
                raise ValueError(f"FITS: row of {dtype.itemsize} bytes from "
                                 f"TFORMs, NAXIS1 says {rowb}")
            nbytes = nrow * rowb
            data = np.frombuffer(buf[pos: pos + nbytes], dtype=dtype).copy()
            pos += nbytes + ((-nbytes) % BLOCK)
        else:
            naxis = hdr.get("NAXIS", 0)
            shape = tuple(hdr[f"NAXIS{i}"] for i in range(naxis, 0, -1))
            n = int(np.prod(shape)) if shape else 0
            dt = np.dtype(_BITPIX2DTYPE[hdr["BITPIX"]])
            nbytes = n * dt.itemsize
            data = (np.frombuffer(buf[pos: pos + nbytes], dtype=dt)
                    .reshape(shape).copy() if n else np.zeros(0, dt))
            pos += nbytes + ((-nbytes) % BLOCK)
        out.append((hdr, data))
    return out


def _has_end(block):
    for off in range(0, BLOCK, CARD):
        if block[off: off + 8].rstrip() == b"END":
            return True
    return False
