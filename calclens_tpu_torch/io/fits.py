"""Minimal pure-numpy FITS reader and writer (no cfitsio/astropy dependency).

The port's own copy of calclens_tpu/io/fits.py: primary image HDUs and
binary-table extensions, per the FITS 4.0 standard (80-byte cards,
2880-byte blocks, big-endian data).  The port reads the HEALPix ring
weights and pixel windows with it (io/weights.py) and writes the lens maps
(maps.py).
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80

_TFORM2DTYPE = {
    "L": ">i1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8",
}
_KIND2TFORM = {
    ("i", 1): "B", ("u", 1): "B", ("i", 2): "I", ("i", 4): "J", ("i", 8): "K",
    ("f", 4): "E", ("f", 8): "D",
}
_BITPIX2DTYPE = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _card(key, value, comment=""):
    # keywords > 8 chars use the HIERARCH convention, as cfitsio does
    head = f"HIERARCH {key} " if len(key) > 8 else f"{key:<8}"
    if value is None:
        text = head
    elif isinstance(value, bool):
        text = f"{head}= {'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        text = f"{head}= {int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        text = f"{head}= {float(value):>20.13E}"
    else:
        text = f"{head}= '{str(value):<8}'"
    if comment:
        text += f" / {comment}"
    return text[:CARD].ljust(CARD).encode("ascii")


def _header_bytes(cards):
    raw = b"".join(cards) + _card("END", None)
    pad = (-len(raw)) % BLOCK
    return raw + b" " * pad


def _data_bytes(arr):
    raw = arr.tobytes()
    pad = (-len(raw)) % BLOCK
    return raw + b"\x00" * pad


def image_hdu(data, header=None, primary=True):
    """(cards, payload) for an image HDU from an int/float ndarray."""
    data = np.ascontiguousarray(data)
    kind, size = data.dtype.kind, data.dtype.itemsize
    bitpix = {("i", 8): 64, ("i", 4): 32, ("i", 2): 16, ("u", 1): 8,
              ("f", 4): -32, ("f", 8): -64}[(kind, size)]
    be = data.astype(_BITPIX2DTYPE[bitpix])
    cards = []
    if primary:
        cards.append(_card("SIMPLE", True, "conforms to FITS standard"))
        cards.append(_card("BITPIX", bitpix))
    else:
        cards.append(_card("XTENSION", "IMAGE", "image extension"))
        cards.append(_card("BITPIX", bitpix))
    cards.append(_card("NAXIS", data.ndim))
    for i, n in enumerate(reversed(data.shape)):
        cards.append(_card(f"NAXIS{i + 1}", n))
    if not primary:
        cards.append(_card("PCOUNT", 0))
        cards.append(_card("GCOUNT", 1))
    for k, v in (header or {}).items():
        val, com = v if isinstance(v, tuple) else (v, "")
        cards.append(_card(k, val, com))
    return cards, be


def bintable_hdu(rec, name="", header=None):
    """(cards, payload) for a BINTABLE extension from a structured array."""
    rec = np.asarray(rec)
    names = rec.dtype.names
    be_fields = []
    tforms = []
    for n in names:
        ft = rec.dtype.fields[n][0]
        base = ft.base
        reps = int(np.prod(ft.shape)) if ft.shape else 1
        code = _KIND2TFORM[(base.kind, base.itemsize)]
        tforms.append(f"{reps}{code}" if reps != 1 else code)
        be_fields.append((n, _TFORM2DTYPE[code], ft.shape) if ft.shape
                         else (n, _TFORM2DTYPE[code]))
    be = np.zeros(len(rec), dtype=np.dtype(be_fields))
    for n in names:
        be[n] = rec[n]
    rowbytes = be.dtype.itemsize
    cards = [
        _card("XTENSION", "BINTABLE", "binary table extension"),
        _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", rowbytes, "width of table in bytes"),
        _card("NAXIS2", len(rec), "number of rows"),
        _card("PCOUNT", 0),
        _card("GCOUNT", 1),
        _card("TFIELDS", len(names)),
    ]
    for i, (n, tf) in enumerate(zip(names, tforms), start=1):
        cards.append(_card(f"TTYPE{i}", n))
        cards.append(_card(f"TFORM{i}", tf))
    if name:
        cards.append(_card("EXTNAME", name))
    for k, v in (header or {}).items():
        val, com = v if isinstance(v, tuple) else (v, "")
        cards.append(_card(k, val, com))
    return cards, be


def write_fits(filename, hdus):
    """hdus: list of (cards, data_array) from image_hdu()/bintable_hdu();
    the first must be a primary image_hdu."""
    with open(filename, "wb") as fp:
        for cards, data in hdus:
            fp.write(_header_bytes(cards))
            fp.write(_data_bytes(data))


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

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
