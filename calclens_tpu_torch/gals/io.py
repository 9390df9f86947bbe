"""Source-galaxy input and image-galaxy output (reference galsio.c).

The port's own copy of calclens_tpu/gals/io.py over the port's io/fits.py
(tests/test_torch_gridsearch.py holds it to the original, byte for byte).

Input: cfg.GalsFileList is a text file listing FITS catalogs; each catalog is
a binary table with px, py, pz columns (comoving Mpc/h).  The source index is
fileNum + NumFiles * rowNum (README.md:259-274) so concatenation can join
images back to their catalogs.

Output: per-plane FITS tables <OutputPath>/<GalOutputName>%04d.%04d.fit with
columns index (K), ra, dec, A00, A01, A10, A11 (D) — galsio.c:14-15,75-356.
"""

from __future__ import annotations

import os

import numpy as np

from . import gridsearch as gs
from ..io import fits


def read_source_gals(gals_file_list):
    """Returns (pos [N,3] float64, index [N] int64)."""
    with open(gals_file_list) as fp:
        files = [line.strip() for line in fp if line.strip()]
    nfiles = len(files)
    pos_list, idx_list = [], []
    for fnum, path in enumerate(files):
        for hdr, data in fits.read_fits(path):
            if not str(hdr.get("XTENSION", "")).startswith("BINTABLE"):
                continue
            names = data.dtype.names
            if not {"px", "py", "pz"} <= set(names):
                continue
            pos = np.stack([data["px"], data["py"], data["pz"]],
                           axis=1).astype(np.float64)
            idx = fnum + nfiles * np.arange(len(pos), dtype=np.int64)
            pos_list.append(pos)
            idx_list.append(idx)
    if not pos_list:
        return np.zeros((0, 3)), np.zeros(0, np.int64)
    return np.concatenate(pos_list), np.concatenate(idx_list)


def write_source_gals(path, pos):
    """Write a source catalog in the input format (testing helper)."""
    rec = np.zeros(len(pos), dtype=np.dtype(
        [("px", "<f8"), ("py", "<f8"), ("pz", "<f8")]))
    rec["px"], rec["py"], rec["pz"] = pos[:, 0], pos[:, 1], pos[:, 2]
    fits.write_fits(path, [
        fits.image_hdu(np.zeros(0, np.int16)),
        fits.bintable_hdu(rec),
    ])


def write_image_gals(cfg, images: "gs.ImageGals", plane_num, file_num=0):
    """One plane's found images -> FITS (file_write_gals2fits layout)."""
    os.makedirs(cfg.OutputPath, exist_ok=True)
    rec = np.zeros(len(images.index), dtype=np.dtype([
        ("index", "<i8"), ("ra", "<f8"), ("dec", "<f8"),
        ("A00", "<f8"), ("A01", "<f8"), ("A10", "<f8"), ("A11", "<f8"),
    ]))
    rec["index"] = images.index
    rec["ra"] = images.ra
    rec["dec"] = images.dec
    rec["A00"] = images.A[:, 0, 0]
    rec["A01"] = images.A[:, 0, 1]
    rec["A10"] = images.A[:, 1, 0]
    rec["A11"] = images.A[:, 1, 1]
    path = os.path.join(
        cfg.OutputPath,
        f"{cfg.GalOutputName}{plane_num:04d}.{file_num:04d}.fit")
    fits.write_fits(path, [
        fits.image_hdu(np.zeros(0, np.int16)),
        fits.bintable_hdu(rec),
    ])
    return path


def read_image_gals(path):
    for hdr, data in fits.read_fits(path):
        if str(hdr.get("XTENSION", "")).startswith("BINTABLE"):
            return data
    raise ValueError(f"no binary table in {path}")
