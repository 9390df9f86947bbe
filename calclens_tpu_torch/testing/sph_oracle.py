"""Exact per-particle SPH deposit — the reference algorithm, as a slow
numpy test oracle for the sigma-bucketed deposit.

The port's own copy of calclens_tpu/testing/sph_oracle.py, held to the
original by tests/test_torch_copies.py.

Reproduces shtpoissonsolve.c:187-291 exactly:
  * adaptive query order: coarsest order whose pixel scale
    sqrt(4 pi / npix) <= sigma / SMOOTHKERN_SHTRESOLVE_FAC, capped at the
    map order (shtpoissonsolve.c:189-196, raytrace.h:128);
  * inclusive disc query of radius sigma at the query order;
  * Epanechnikov kernel K = 1 - (gamma/sigma)^2 at query-pixel centers
    (partsmoothdens.c:84-141; the analytic norm cancels under the
    per-particle normalization);
  * per-particle discrete normalization over the positive-kernel pixels
    (mass conservation, shtpoissonsolve.c:216-229);
  * mass spread uniformly over each query pixel's fine map children
    (shtpoissonsolve.c:231-263);
  * NGP fallback when no pixel survives (shtpoissonsolve.c:268-287).
"""

from __future__ import annotations

import numpy as np

from ..healpix import core as hp

SMOOTHKERN_SHTRESOLVE_FAC = 3.0  # raytrace.h:128


def deposit_sph_exact(order: int, pos, mass, sl):
    """pos [N, 3], mass [N], sl [N] angular smoothing lengths ->
    RING-ordered [npix] map of mass (in the same 1/MASS_SCALE units as
    ops.deposit)."""
    from ..ops.deposit import MASS_SCALE

    npix = int(hp.order2npix(order))
    out = np.zeros(npix)
    gs = np.sqrt(4.0 * np.pi / hp.order2npix(np.arange(order + 1)))
    pos = np.asarray(pos, np.float64)
    r = np.linalg.norm(pos, axis=1)
    vec = pos / r[:, None]
    theta, phi = hp.vec2ang(vec)

    for i in range(len(mass)):
        sigma = float(sl[i])
        q = 0
        while gs[q] > sigma / SMOOTHKERN_SHTRESOLVE_FAC and q < order:
            q += 1
        shift = 2 * (order - q)
        nchild = 1 << shift

        qpix_ring = hp.query_disc(float(theta[i]), float(phi[i]), sigma, q)
        if len(qpix_ring):
            cvec = hp.pix2vec_ring(qpix_ring, q)
            cosg = np.clip(cvec @ vec[i], -1.0, 1.0)
            rs = np.arccos(cosg) / sigma
            k = 1.0 - rs * rs
            keep = k > 0.0
        else:
            keep = np.zeros(0, bool)
        if keep.any():
            qnest = hp.ring2nest(qpix_ring[keep], q)
            w = k[keep]
            w = w / w.sum() / nchild * (mass[i] / MASS_SCALE)
            for qn, wn in zip(qnest, w):
                children_nest = (qn << shift) + np.arange(nchild)
                out[hp.nest2ring(children_nest, order)] += wn
        else:
            # NGP fallback
            out[hp.vec2pix_ring(vec[i][None, :], order)[0]] += (
                mass[i] / MASS_SCALE)
    return out
