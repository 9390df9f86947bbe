"""Point-mass analytic end-to-end test harness.

The port's own copy of calclens_tpu/testing/pointmass.py, on the port's
config, cosmology, healpix.core and io.lensplanes; held to the original by
tests/test_torch_copies.py.

Analog of the reference's POINTMASSTEST pipeline
(lensplanes/make_lensplanes_pointmass_test.c): writes a lens-plane set
containing a single particle of mass M at (ra, dec, chi), plus the analytic
lensing quantities to compare the trace against.

Analytic solution, in the framework's conventions (h=1 units; the deposited
"charge" is q = M * densfact with densfact = 8 pi G (1+z_L) / (c^2 chi_L),
raytrace.c:417-423):

  potential      phi(gamma)  = (q/2pi) ln sin(gamma/2) + const   [a well]
  deflection     alpha(gamma) = (q/4pi) cot(gamma/2)   [toward the mass]
                 ~ 4 G M (1+z_L) / (c^2 chi_L gamma)  for small gamma
  shear (source at w_s, single plane at w_L, small gamma):
                 gamma_t = (w_s - w_L)/w_s * alpha(gamma)/gamma, kappa = 0.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.special import eval_legendre

from ..config import RayTraceConfig
from ..cosmology import Cosmology, RHO_CRIT, CSOL
from ..healpix import core as hp
from ..io import lensplanes

G_OVER_C2 = 3.0 * (100.0 / CSOL) ** 2 / (8.0 * np.pi * RHO_CRIT)  # Mpc/Msun (h=1)


def make_pointmass_planes(cfg: RayTraceConfig, snap_to_pixel_order=None):
    """Write cfg.NumLensPlanes plane files with one particle of cfg.partMass
    at (raPointMass, decPointMass, radPointMass).  Returns the particle's
    unit vector (optionally snapped to its deposit-pixel center so analytic
    comparisons are free of NGP quantization)."""
    os.makedirs(cfg.LensPlanePath, exist_ok=True)
    theta, phi = hp.radec2ang(cfg.raPointMass, cfg.decPointMass)
    vec = hp.ang2vec(theta, phi)
    if snap_to_pixel_order is not None:
        pix = hp.ang2pix_ring(theta, phi, snap_to_pixel_order)
        vec = hp.pix2vec_ring(pix, snap_to_pixel_order)
    pos = vec * cfg.radPointMass

    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    mass_plane = min(int(cfg.radPointMass / binL), cfg.NumLensPlanes - 1)
    for p in range(cfg.NumLensPlanes):
        fn = lensplanes.plane_filename(cfg.LensPlanePath, cfg.LensPlaneName, p)
        if p == mass_plane:
            lensplanes.write_plane(fn, cfg.SHTOrder, pos[None, :], [cfg.partMass])
        else:
            lensplanes.write_plane(fn, cfg.SHTOrder, np.zeros((0, 3)), [])
    return vec, mass_plane


def charge(cfg: RayTraceConfig, cosmo: Cosmology, chi_lens: float) -> float:
    """q = M * densfact for the point-mass radial-volume convention."""
    z = 1.0 / cosmo.acomvdist(chi_lens) - 1.0
    return float(cfg.partMass * 8.0 * np.pi * G_OVER_C2 * (1.0 + z) / chi_lens)


def alpha_exact(gamma, q):
    """Exact on-sphere bend angle (toward the mass)."""
    return q / (4.0 * np.pi) / np.tan(gamma / 2.0)


def alpha_smallangle(gamma, q):
    return q / (2.0 * np.pi * gamma)


def alpha_bandlimited(gamma, q, lmax, bl=None):
    """Deflection of the lmax-truncated harmonic representation:
    alpha = q * sum_{l=1}^{lmax} b_l (2l+1)/(4 pi l(l+1)) * (-dP_l(cos g)/dg),
    with an optional window b_l matching the solver's smoothing beam."""
    gamma = np.atleast_1d(gamma)
    x = np.cos(gamma)
    total = np.zeros_like(gamma)
    if bl is None:
        bl = np.ones(lmax + 1)
    for l in range(1, lmax + 1):
        # dP_l/dgamma = -sin(g) P_l'(x);  P_l'(x) = l (x P_l - P_{l-1})/(x^2-1)
        pl = eval_legendre(l, x)
        plm1 = eval_legendre(l - 1, x)
        dpdx = l * (x * pl - plm1) / (x * x - 1.0)
        total += bl[l] * (2 * l + 1.0) / (4.0 * np.pi * l * (l + 1.0)) * (np.sin(gamma) * dpdx)
    return q * total


def shear_tangential(gamma, q, w_lens, w_source):
    """|shear| of the final inverse-magnification matrix for a source at
    w_source (small-angle, single plane)."""
    f = (w_source - w_lens) / w_source
    return f * alpha_smallangle(gamma, q) / gamma


# ----------------------------------------------------------------------------
# NFW halo test (reference make_lensplanes_pointmass_test.c:247-367,
# NFWHALOTEST branch): Monte-Carlo-sampled NFW halo + analytic deflection
# ----------------------------------------------------------------------------

def nfw_rho(r, r200, conc, overdens=200.0):
    """3D NFW profile normalized so the mean density within r200 equals
    overdens (threedNFWprof)."""
    rs = r200 / conc
    x = r / rs
    mu = np.log(1.0 + conc) - conc / (1.0 + conc)
    rho_s = overdens / 3.0 * conc**3 / mu
    return rho_s / (x * (1.0 + x) ** 2)


def nfw_mass_2d(R, r200, conc, m200):
    """Projected mass inside transverse radius R of an (untruncated) NFW
    halo (Wright & Brainerd 2000), for the analytic bend angle."""
    rs = r200 / conc
    mu = np.log(1.0 + conc) - conc / (1.0 + conc)
    m_s = m200 / mu  # 4 pi rho_s rs^3
    x = np.atleast_1d(R / rs)
    out = np.empty_like(x)
    lo = x < 1.0
    hi = x > 1.0
    out[lo] = np.log(x[lo] / 2.0) + np.arccosh(1.0 / x[lo]) / np.sqrt(1.0 - x[lo] ** 2)
    out[hi] = np.log(x[hi] / 2.0) + np.arccos(1.0 / x[hi]) / np.sqrt(x[hi] ** 2 - 1.0)
    out[~lo & ~hi] = 1.0 + np.log(0.5)
    return m_s * out


def sample_nfw(rng, n, r200, conc, rmax=None):
    """Rejection-sample radii from rho(r) r^2 (NFW_ptgen), isotropic angles.
    Returns offsets [n, 3] in the same units as r200."""
    rs = r200 / conc
    rmax = rmax if rmax is not None else 3.0 * r200
    fmax = nfw_rho(rs, r200, conc) * rs * rs
    out = np.empty(n)
    got = 0
    while got < n:
        r = rng.uniform(0.0, rmax, size=2 * (n - got))
        y = rng.uniform(0.0, fmax, size=len(r))
        keep = r[y < nfw_rho(np.maximum(r, 1e-6 * rs), r200, conc) * r * r]
        take = keep[: n - got]
        out[got: got + len(take)] = take
        got += len(take)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * out[:, None]


def make_nfw_planes(cfg: RayTraceConfig, n_parts=200000, conc=5.0,
                    overdens=200.0, seed=13):
    """Write plane files containing a Monte-Carlo NFW halo of total mass
    cfg.partMass (M200) at (raPointMass, decPointMass, radPointMass).
    Returns (center unit vector, plane number, r200)."""
    os.makedirs(cfg.LensPlanePath, exist_ok=True)
    rng = np.random.default_rng(seed)
    m200 = cfg.partMass
    r200 = (3.0 * m200 / (4.0 * np.pi * overdens * RHO_CRIT * cfg.OmegaM)) ** (1.0 / 3.0)
    theta, phi = hp.radec2ang(cfg.raPointMass, cfg.decPointMass)
    vec = hp.ang2vec(theta, phi)
    center = vec * cfg.radPointMass
    offs = sample_nfw(rng, n_parts, r200, conc, rmax=r200)
    pos = center[None, :] + offs
    # particle mass: the sampled (truncated at r200) mass equals M200
    mass = np.full(n_parts, m200 / n_parts)

    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    plane_of = (np.linalg.norm(pos, axis=1) / binL).astype(np.int64)
    for p in range(cfg.NumLensPlanes):
        fn = lensplanes.plane_filename(cfg.LensPlanePath, cfg.LensPlaneName, p)
        sel = plane_of == p
        lensplanes.write_plane(fn, cfg.SHTOrder, pos[sel], mass[sel])
    return vec, min(int(cfg.radPointMass / binL), cfg.NumLensPlanes - 1), r200


def alpha_nfw(gamma, cfg, cosmo, chi_lens, r200, conc, m200):
    """Analytic NFW bend angle at angular radius gamma (small-angle):
    alpha = 4 G M2D(R) (1+z) / (c^2 R) with R = chi * gamma."""
    z = 1.0 / cosmo.acomvdist(chi_lens) - 1.0
    R = chi_lens * np.asarray(gamma)
    m2d = nfw_mass_2d(R, r200, conc, m200)
    return 4.0 * G_OVER_C2 * m2d * (1.0 + z) / (chi_lens * np.asarray(gamma))
