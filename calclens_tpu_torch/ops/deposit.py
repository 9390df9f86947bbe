"""Particle -> HEALPix surface-density deposit (reference shtpoissonsolve.c
step 1, :110-291): NGP, CIC and the sigma-bucketed SPH scheme.

Port of calclens_tpu/ops/deposit.py: scatter-adds straight into the
RING-ordered map, the SHT's native layout.  Masses are scaled by
1/MASS_SCALE at deposit and rescaled in the Poisson solve
(shtpoissonsolve.c:36,153) to keep float32 sums in range.  Every
scatter-add goes through add_at, which sums the values that meet in one
pixel in a fixed order: the same bits on every run, on the card too.

The SPH windows (kernel_bl, pixwin_disc_bl) are host numpy.  They give the
JAX package's values bit for bit, but from one Legendre recurrence over all
degrees (legendre_table) instead of scipy's eval_legendre, whose cost per
call grows with the degree: at lmax 12287 that route takes minutes per
window.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import eval_legendre

from ..healpix import torchhp

MASS_SCALE = 1e10  # reference shtpoissonsolve.c:36


def add_at(out, idx, vals, dim=0):
    """out[idx[i]] += vals[i] along dim for every i (the JAX package's
    out.at[idx].add(vals)), in place, with the same bits on every run.

    index_add_ on a CUDA tensor adds with atomics, so values that meet in
    one element are summed in an order that changes from run to run.  Here
    the indices are sorted stably, each run of equal indices is summed one
    value after another in the order of i (XLA's order on the CPU), and the
    sums are added to distinct elements: on the same inputs, the same bits
    on the card as on the CPU.  The values go to segment_reduce as columns of a 2-D tensor,
    which it sums with one thread per run and column (on a 1-D tensor its
    CUDA form gives each run a tree of its own, in another order and far
    slower on runs of a few values).  One host sync (the number of
    distinct indices).  Indices are sorted as int32 where out allows it."""
    if idx.numel() == 0:
        return out
    if out.shape[dim] < 2**31:
        idx = idx.to(torch.int32)
    key, perm = torch.sort(idx, stable=True)
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    v = vals.index_select(dim, perm).movedim(dim, 0)
    sums = torch.segment_reduce(v.reshape(len(v), -1), "sum", lengths=counts)
    return out.index_add_(dim, uniq,
                          sums.view(-1, *v.shape[1:]).movedim(0, dim))


def deposit_ngp(order: int, pos, mass, npix: int):
    """Nearest-grid-point deposit.  pos [N, 3] (any radius), mass [N]."""
    theta, phi = torchhp.vec2ang(pos)
    pix = torchhp.ang2pix_ring(theta, phi, order)
    m = torch.zeros((npix,), dtype=mass.dtype, device=mass.device)
    return add_at(m, pix, mass / MASS_SCALE)


def deposit_cic(tab: torchhp.InterpTables, pos, mass):
    """Cloud-in-cell deposit using the bilinear interpolation weights
    (shtpoissonsolve.c:159-185): the four taps' adds in the JAX package's
    order (tap by tap, particle by particle), as one add_at."""
    theta, phi = torchhp.vec2ang(pos)
    pix, wgt = torchhp.get_interpol(tab, theta, phi)
    m = torch.zeros((tab.npix,), dtype=mass.dtype, device=mass.device)
    return add_at(m, pix.T.reshape(-1),
                  (mass[None, :] * wgt.T / MASS_SCALE).reshape(-1))


def smoothing_lengths(pos, comv_smoothing_scale, min_sl, max_sl):
    """Angular smoothing length per particle, clamped (reference
    get_smoothing_lengths, partsmoothdens.c:14-81 + raytrace.c:425-450)."""
    r = torch.linalg.vector_norm(pos, dim=-1)
    sl = comv_smoothing_scale / torch.clamp(r, min=1e-12)
    return torch.clamp(sl, min_sl, max_sl)


def sph_sigma_grid(min_sl, max_sl, nbuckets=8):
    """Static log-spaced bucket centres for the sigma-bucketed deposit."""
    return np.geomspace(min_sl, max_sl, nbuckets)


def deposit_sph_bucketed(order: int, pos, mass, sl, sigmas, npix: int,
                         tab=None):
    """SPH deposit in the JAX package's formulation: particles deposit onto
    B = len(sigmas) maps, by CIC (bilinear sub-pixel placement) when `tab`
    is given, else NGP; each bucket's spline-kernel smoothing is applied
    afterwards in harmonic space (kernel_bl, poisson.phase_analysis_sph).
    Each particle's mass is split between its two bracketing sigma buckets,
    linearly in ln sigma.

    One flat [B * npix] buffer indexed by int64 bucket * npix + pixel (the
    JAX package's int32 and 2D scatter forms give the same sums).  Returns
    the [B, npix] view."""
    theta, phi = torchhp.vec2ang(pos)
    B = len(sigmas)
    logsig = torch.log(torch.as_tensor(np.asarray(sigmas), dtype=sl.dtype,
                                       device=sl.device))
    logsl = torch.log(sl)
    hi = torch.clamp(torch.searchsorted(logsig, logsl), 1, B - 1)
    lo = hi - 1
    t = torch.clamp((logsl - logsig[lo]) / (logsig[hi] - logsig[lo]),
                    0.0, 1.0)
    m = torch.zeros((B * npix,), dtype=mass.dtype, device=mass.device)
    if tab is not None:
        # per tap, the low bucket's adds then the high bucket's, as the
        # JAX package orders them, each weight rounded as it rounds it
        pix4, wgt = torchhp.get_interpol(tab, theta, phi)
        mw = mass[:, None] * wgt
        idx = torch.stack([lo[:, None] * npix + pix4,
                           hi[:, None] * npix + pix4])  # [2, N, 4]
        val = torch.stack([mw * (1.0 - t)[:, None] / MASS_SCALE,
                           mw * t[:, None] / MASS_SCALE])
        return add_at(m, idx.permute(2, 0, 1).reshape(-1),
                      val.permute(2, 0, 1).reshape(-1)).view(B, npix)
    pix = torchhp.ang2pix_ring(theta, phi, order)
    return add_at(m, torch.cat([lo * npix + pix, hi * npix + pix]),
                  torch.cat([mass * (1.0 - t) / MASS_SCALE,
                             mass * t / MASS_SCALE])).view(B, npix)


def legendre_table(lmax: int, x):
    """P_l(x) for l = 0..lmax at each x, [lmax + 1, len(x)] float64: equal
    bit for bit to scipy.special.eval_legendre(l, x) at integer l, whose
    recurrence for one degree passes through every lower degree's value
    (x within 1e-5 of 0 takes its power series, from scipy)."""
    x = np.asarray(x, dtype=np.float64)
    P = np.empty((lmax + 1, len(x)))
    P[0] = 1.0
    if lmax >= 1:
        P[1] = x
    xm1 = x - 1.0
    d = x - 1.0
    p = x.copy()
    for kk in range(lmax - 1):
        k = kk + 1.0
        d = ((2 * k + 1) / (k + 1)) * xm1 * p + (k / (k + 1)) * d
        p = p + d
        P[kk + 2] = p
    small = np.abs(x) < 1e-5
    if small.any():
        P[:, small] = eval_legendre(np.arange(lmax + 1)[:, None],
                                    x[small][None, :])
    return P


def pixwin_disc_bl(order: int, lmax: int):
    """Isotropic pixel-assignment window: Legendre transform of the
    equal-area disc (radius R with pi R^2 = 4 pi / npix).  The CIC cloud's
    effective window is ~ this squared; the SPH solve divides it out so the
    band-limited kernel is centred at the exact particle position."""
    R = np.sqrt(4.0 / (12.0 * 4.0**order))
    g = np.linspace(0.0, R, 513)
    x = np.cos(g)
    w = np.gradient(g) * np.sin(g)
    bl = legendre_table(lmax, x) @ w
    return bl / bl[0]


def kernel_bl(sigma, lmax):
    """Legendre transform of the normalized Epanechnikov-like spline kernel
    K(gamma) ~ max(1 - (gamma/sigma)^2, 0) (partsmoothdens.c:84-141):
    b_l = 2 pi int K(g) P_l(cos g) sin g dg, normalized so b_0 = 1."""
    ng = 512
    g = np.linspace(0.0, sigma, ng + 1)
    k = np.maximum(1.0 - (g / sigma) ** 2, 0.0)
    x = np.cos(g)
    w = np.gradient(g) * np.sin(g) * k
    bl = legendre_table(lmax, x) @ w
    return bl / bl[0]


def scale_density(dens, densfact, backdens, pixarea, vacmask=None):
    """densfact/pixarea scaling and background subtraction
    (shtpoissonsolve.c:454-502).  vacmask marks pixels outside the cut-sky
    region (zeroed instead of background-subtracted)."""
    out = dens * (densfact / pixarea * MASS_SCALE) - backdens
    if vacmask is not None:
        out = out.masked_fill(vacmask, 0.0)
    return out
