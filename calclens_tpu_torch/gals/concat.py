"""Postprocessing: concatenate per-plane image-galaxy outputs and join them
back to the source catalogs (reference scripts/concat.py + catwriter.py).

The port's own copy of calclens_tpu/gals/concat.py over the port's
io/fits.py (tests/test_torch_gridsearch.py holds it to the original).

The source index encodes (fileNum, rowNum) as index = fileNum +
NumFiles * rowNum (galsio.c / README.md:259-274), so images are routed to
the catalog file they came from; one ``lensed_<catalog>`` FITS per input
catalog carries the source columns plus the image quantities.
"""

from __future__ import annotations

import os

import numpy as np

from ..io import fits


def read_all_images(output_path, gal_output_name, num_planes, num_files=1):
    """All ImageGal rows from every per-plane output file."""
    rows = []
    for p in range(num_planes):
        for f in range(num_files):
            fn = os.path.join(output_path,
                              f"{gal_output_name}{p:04d}.{f:04d}.fit")
            if not os.path.exists(fn):
                continue
            for hdr, data in fits.read_fits(fn):
                if str(hdr.get("XTENSION", "")).startswith("BINTABLE") and len(data):
                    rows.append(data)
    if not rows:
        return np.zeros(0, dtype=np.dtype(
            [("index", "<i8"), ("ra", "<f8"), ("dec", "<f8"),
             ("A00", "<f8"), ("A01", "<f8"), ("A10", "<f8"), ("A11", "<f8")]))
    return np.concatenate(rows)


def write_lensed_catalogs(gals_file_list, images, out_path):
    """Join images to their source catalogs; write lensed_<name> files with
    source columns + image ra/dec/A + derived kappa/gamma/mu."""
    with open(gals_file_list) as fp:
        files = [line.strip() for line in fp if line.strip()]
    nfiles = len(files)
    os.makedirs(out_path, exist_ok=True)

    fnum = images["index"] % nfiles
    rownum = images["index"] // nfiles
    outputs = []
    for fi, path in enumerate(files):
        src = None
        for hdr, data in fits.read_fits(path):
            if str(hdr.get("XTENSION", "")).startswith("BINTABLE"):
                src = data
                break
        sel = fnum == fi
        img = images[sel]
        rows = rownum[sel]
        fields = [(n, src.dtype.fields[n][0].str) for n in src.dtype.names]
        fields += [("ra", "<f8"), ("dec", "<f8"),
                   ("A00", "<f8"), ("A01", "<f8"),
                   ("A10", "<f8"), ("A11", "<f8"),
                   ("kappa", "<f8"), ("gamma1", "<f8"), ("gamma2", "<f8"),
                   ("mu", "<f8")]
        rec = np.zeros(len(img), dtype=np.dtype(fields))
        for n in src.dtype.names:
            rec[n] = src[n][rows]
        for n in ("ra", "dec", "A00", "A01", "A10", "A11"):
            rec[n] = img[n]
        A00, A01, A10, A11 = img["A00"], img["A01"], img["A10"], img["A11"]
        rec["kappa"] = 1.0 - 0.5 * (A00 + A11)
        rec["gamma1"] = 0.5 * (A11 - A00)
        rec["gamma2"] = -0.5 * (A01 + A10)
        det = A00 * A11 - A01 * A10
        rec["mu"] = 1.0 / np.where(det != 0.0, det, np.inf)
        out = os.path.join(out_path, "lensed_" + os.path.basename(path))
        fits.write_fits(out, [
            fits.image_hdu(np.zeros(0, np.int16)),
            fits.bintable_hdu(rec),
        ])
        outputs.append(out)
    return outputs
