"""The yardstick of the Legendre kernels: the work each transform needs,
counted from its shapes, and the least time the card could take for it.

The count is of (l, m, ring pair) elements of the Legendre sums that a
transform at these shapes needs under the algorithm's turning-point cutoff,
per ring: lambda_lm(theta) is damped below float32 significance for
m > l sin(theta) + margin, margin = max(100, lmax / 100) + 21 (the l-min
cutoff of HEALPix's Ylm generator, seen from the m side as the program's
sht/transforms.m_cutoff states it).  So ring pair j needs, for each m, the
degrees l = max(m, ceil((m - margin) / sin theta_j)) .. lmax.  No kernel's
tiling enters: a kernel that walks more degrees reads the same work.

Operations per element (a frozen copy of the program's
tools/roofline_legendre.py arithmetic): the recurrence 4 FP32 operations
(3 multiplies and a subtraction) on the CUDA cores; the contraction 5 for
the analysis, 17 for the six-map synthesis, 5 for the potential-only one
(an FMA counts 2).  Bytes: the transform's input read once and its output
written once, in float32.  The least time is the largest of the
recurrence at the FP32 peak, the contraction at the fastest peak that keeps
float32 accuracy (split TF32 on the tensor cores: 3 products each), and
the bytes at the HBM peak.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks():
    with open(os.path.join(HERE, "peaks.json")) as fp:
        return json.load(fp)


def margin(lmax):
    return max(100.0, 0.01 * lmax) + 21.0


def ring_pair_sines(order):
    """sin theta of the northern rings and the equator, one per ring pair
    (J = 2 nside), in float64."""
    ns = 1 << order
    i = np.arange(1, 2 * ns + 1, dtype=np.float64)
    one_m_z = np.where(i < ns, i * i / (3.0 * ns * ns),
                       1.0 - (2 * ns - i) * 2.0 / (3.0 * ns))
    return np.sqrt(one_m_z * (2.0 - one_m_z))


def elements(order, lmax=None, mg=None):
    """(l, m, ring pair) elements one transform needs at this order (mg:
    the cutoff's margin, margin(lmax) by default)."""
    L = 3 * (1 << order) - 1 if lmax is None else int(lmax)
    mg = margin(L) if mg is None else mg
    m = np.arange(L + 1, dtype=np.float64)
    total = 0
    for s in ring_pair_sines(order):
        lmin = np.maximum(m, np.ceil((m - mg) / s))
        total += int(np.clip(L - lmin + 1, 0, None).sum())
    return total


def elements_brute(order, lmax=None, mg=None):
    """elements() by a loop over every (l, m, ring pair): the check."""
    L = 3 * (1 << order) - 1 if lmax is None else int(lmax)
    mg = margin(L) if mg is None else mg
    n = 0
    for s in ring_pair_sines(order):
        for mm in range(L + 1):
            for l in range(mm, L + 1):
                if mm <= l * s + mg:
                    n += 1
    return n


def transform_bytes(function, order, lmax=None):
    """Input read once and output written once (float32) by one transform:
    the analysis reads the folded ring sums (two complex [nm, J] planes)
    and writes alm; a synthesis reads alm and writes, per m and ring pair,
    complex sums for both hemispheres (3 of them with derivatives, 1
    without)."""
    L = 3 * (1 << order) - 1 if lmax is None else int(lmax)
    nm, J = L + 1, 2 * (1 << order)
    alm = 8 * (L + 1) * nm
    if function == "analysis":
        return 2 * 8 * nm * J + alm
    cols = 3 if function == "synthesis" else 1
    return alm + 2 * cols * 8 * nm * J


def least_seconds(spec, function, order, lmax=None):
    """The least time (s) of one transform on the card, and its bound."""
    pk = peaks()
    E = elements(order, lmax)
    rec = spec["flops_recurrence"] * E / pk["fp32_flops"]
    con = spec["flops_contraction"][function] * E / (
        pk["tf32_flops"] / pk["tf32_products_per_fp32"])
    byt = transform_bytes(function, order, lmax) / pk["hbm_bytes_per_s"]
    bound = max(("recurrence", rec), ("contraction", con), ("bytes", byt),
                key=lambda t: t[1])
    return bound[1], bound[0]


def trace_share(run, spec_name, function, per_plane):
    """A Legendre function's share of its roofline in a traced run (%):
    the least time of the transforms the profiled planes ran, per_plane of
    them a plane, over the device time of the kernels that implement the
    function (kernels/<spec_name>.json); None where the trace has none."""
    if run.trace is None:
        return None
    with open(os.path.join(HERE, "kernels", spec_name + ".json")) as fp:
        spec = json.load(fp)
    seconds, launches = run.trace.kernel_seconds(spec["kernels"])
    if not launches or seconds <= 0:
        return None
    least, _ = least_seconds(spec, function, run.cfg.SHTOrder)
    return 100.0 * run.trace_planes * per_plane * least / seconds
