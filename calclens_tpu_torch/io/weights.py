"""HEALPix quadrature ring weights and pixel window functions
(reference read_ring_weights / read_window_function,
healpix_shtrans.c:361-471).

The port's own copy of calclens_tpu/io/weights.py.  Standard HEALPix
distribution files:
  <path>/weight_ring_n<nside:05d>.fits : bintable ext, 2*nside rows of
      TEMPERATURE WEIGHTS storing w - 1 (applied as 1 + w per ring pair)
  <path>/pixel_window_n<nside:04d>.fits : bintable ext, 4*nside+1 rows of
      TEMPERATURE window b_l
"""

from __future__ import annotations

import os

import numpy as np

from . import fits


def _first_column(fn, nrows, what):
    for hdr, data in fits.read_fits(fn):
        if str(hdr.get("XTENSION", "")).startswith("BINTABLE"):
            w = np.asarray(data[data.dtype.names[0]], np.float64)
            if len(w) != nrows:
                raise ValueError(f"{fn}: {len(w)} {what} rows, expected "
                                 f"{nrows}")
            return w
    raise ValueError(f"no binary table in {fn}")


def read_ring_weights(path, order):
    """Full multiplicative ring corrections [2*nside] (1 + stored value)."""
    nside = 1 << order
    fn = os.path.join(path, f"weight_ring_n{nside:05d}.fits")
    return 1.0 + _first_column(fn, 2 * nside, "ring-weight")


def read_pixel_window(path, order):
    """Temperature pixel window b_l [4*nside + 1]."""
    nside = 1 << order
    fn = os.path.join(path, f"pixel_window_n{nside:04d}.fits")
    return _first_column(fn, 4 * nside + 1, "pixel-window")
