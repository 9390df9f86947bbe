"""Spherical-harmonic transforms of the full-sky plane step.

Port of calclens_tpu/sht/transforms.py (unstreamed single-device path; the
reference's map2alm_transpose_mpi.c and alm2allmaps_transpose_mpi.c):

  * ring DFTs: the bucketed belt-rfft + cap chirp-Z stage for the analysis
    (rings.py), the uniform chirp-Z over all rings for the synthesis;
  * north/south ring pairs folded into J = 2*nside even/odd combinations;
  * the Legendre sweeps in sht/legendre.py: kernel K1 (analysis) and K2
    (synthesis with derivatives) for CUDA tensors, their plain twins for CPU
    tensors;
  * the six covariant outputs phi, d_theta, d_phi/sin and the covariant
    second derivatives, with the cot corrections of
    alm2allmaps_transpose_mpi.c:1094-1147 applied in ring-row space.
"""

from __future__ import annotations

import numpy as np
import torch

from . import legendre
from .czt import czt_blocked
from .plan import SHTPlan


def analysis_rings(plan: SHTPlan, maps):
    """RING map(s) [..., npix] -> G_m per ring [..., nrings_pad, nm]."""
    return plan.ring_stage().analysis(maps)


def synthesis_rings(plan: SHTPlan, Q):
    """q_m per ring [..., nrings_pad, nm] -> RING map(s) [..., npix],

    map(r, p) = Re sum_m (2 - delta_m0) q_m e^{i m phi_rp},

    by the uniform chirp-Z over all rings (one shape for every ring)."""
    wfold = torch.where(plan.m_int == 0, 1.0, 2.0).to(plan.dtype)
    Y = Q * wfold[None, :] * plan.ring_phase(+1)
    lead = Y.shape[:-2]
    Yf = Y.reshape((-1,) + Y.shape[-2:])
    out = []
    for i in range(Yf.shape[0]):
        X = czt_blocked(Yf[i], plan.n_dev, plan.P, plan.L, +1, plan.cdtype,
                        plan.ring_block, real=True)
        out.append(plan.rings_to_map(X.to(plan.dtype)))
        del X
    res = torch.stack(out, dim=0)
    return res.reshape(lead + res.shape[-1:])


def fold_pairs(plan: SHTPlan, G):
    """G [nrings_pad, nm] -> quadrature-weighted even/odd parts E, O
    [nm, J] (contiguous)."""
    jj = torch.arange(plan.J, device=G.device)
    GN = G[jj]                       # [J, nm]
    GS = G[plan.nrings - 1 - jj]     # equator row duplicated; wS[J-1] = 0
    E = (plan.wN[:, None] * GN + plan.wS[:, None] * GS).T.contiguous()
    O = (plan.wN[:, None] * GN - plan.wS[:, None] * GS).T.contiguous()
    return E, O


def unfold_pairs(plan: SHTPlan, qN, qS):
    """[nm, J] north/south ring values -> [nrings_pad, nm]."""
    north = qN.T                                   # rings 0..J-1
    south = qS[:, : plan.J - 1].flip(1).T          # rings J..nrings-1
    pad = torch.zeros((plan.nrings_pad - plan.nrings, plan.nm),
                      dtype=qN.dtype, device=qN.device)
    return torch.cat([north, south, pad], dim=0)


def m_cutoff(lmax: int, sth_max: float, nm: int, granularity: int = 512):
    """Turning-point m cutoff for rings with sin(theta) <= sth_max.

    lambda_lm(theta) is exponentially damped for m > l sin(theta); above
    m ~ lmax sin(theta) + margin every degree l <= lmax is damped below f32
    significance, so those m columns can be skipped (the m-side view of the
    reference's lmin cutoff, healpix_shtrans.c:533-544).  Rounded up to
    `granularity`."""
    mlim = lmax * float(sth_max) + max(100.0, 0.01 * lmax) + 21.0
    mc = int(np.ceil(mlim)) + 1
    if mc >= nm:
        return nm
    return max(min(nm, -(-mc // granularity) * granularity), 1)


def legendre_analysis(plan: SHTPlan, E, O):
    """E, O [nm, J] complex (quadrature-folded even/odd ring pairs) -> alm
    [nl, nm] complex (entries m > l are 0): kernel K1 for CUDA tensors, its
    twin for CPU tensors."""
    re, im = legendre.analysis_columns(*legendre.analysis_inputs(plan, E, O),
                                       plan.nl)
    return torch.complex(re, im).T.contiguous().to(plan.cdtype)


def legendre_synthesis(plan: SHTPlan, alm, derivs: bool = True):
    """alm [nl, nm] complex -> (qN, qS), each [3, nm, J] complex (phi,
    d_theta, d_theta_theta): kernel K2 for CUDA tensors, its twin for CPU
    tensors."""
    if not derivs:
        raise NotImplementedError(
            "potential-only synthesis (4 columns, alm2map) belongs to the "
            "multigrid slice (ROADMAP Queue 1, slice 11)")
    streams = legendre.mx_prep(plan.nl, plan.nm, alm, plan.dtype)
    c = legendre.synth_columns(*streams, plan.cth, plan.ln_sth, plan.logc)
    del streams
    return legendre.q_from_columns(plan, c)


def map2alm(plan: SHTPlan, m):
    """RING map [npix] -> alm [nl, nm] complex (l-major; entries m > l are 0),

    alm = sum_rings w_r lambda_lm(theta_r) G_m(r) with the reference's
    quadrature weights (map2alm_transpose_mpi.c:110-124)."""
    G = analysis_rings(plan, m)
    E, O = fold_pairs(plan, G)
    del G
    return legendre_analysis(plan, E, O)


def _streams_from_q_rows(plan, qphi, qth, qthth, sth, cot):
    """Six covariant-corrected synthesis streams in ring-row space
    [6, rows, nm] (inputs [rows, nm]).  The ring DFT is linear and the
    1/sin(theta) correction factors are constant within a ring, so applying
    them to ring rows is exact.  sth/cot are host [rows] arrays (0 on
    padding rows)."""
    dev = qphi.device
    im = (1j * plan.m_f.to(plan.cdtype))[None, :]
    m2 = plan.m_f[None, :] ** 2
    with np.errstate(divide="ignore"):
        inv_np = np.where(np.asarray(sth) > 0, 1.0 / np.asarray(sth), 0.0)
    inv = torch.as_tensor(inv_np, dtype=plan.dtype, device=dev)[:, None]
    cot = torch.as_tensor(np.asarray(cot), dtype=plan.dtype, device=dev)[:, None]
    gp = qphi * im * inv
    return torch.stack([
        qphi,                                    # pot
        qth,                                     # d_theta
        gp,                                      # d_phi / sin
        qthth,                                   # d_theta_theta
        qth * im * inv - cot * gp,               # d_theta_phi cov
        -(qphi * m2) * (inv * inv) + cot * qth,  # d_phi_phi cov
    ])


def alm2allmaps(plan: SHTPlan, alm):
    """alm -> [6, npix]: phi, d_theta, d_phi, d_theta_theta, d_theta_phi,
    d_phi_phi, the covariant components on the orthonormal (e_theta,
    e_phi) basis (alm2allmaps_transpose_mpi.c:121-131, 1080-1147)."""
    qN, qS = legendre_synthesis(plan, alm, True)
    qrows = [unfold_pairs(plan, qN[k], qS[k]) for k in range(3)]
    del qN, qS
    sth = np.zeros(plan.nrings_pad)
    cot = np.zeros(plan.nrings_pad)
    sth[: plan.nrings] = plan.sth_ring[: plan.nrings]
    cot[: plan.nrings] = plan.cot_ring[: plan.nrings]
    streams = _streams_from_q_rows(plan, *qrows, sth, cot)
    del qrows
    # the six synthesis chirp-Z pipelines run in pairs to bound peak memory,
    # each pair written in place into the one output buffer
    out = torch.empty((6, plan.npix), dtype=plan.dtype, device=alm.device)
    for i in range(0, 6, 2):
        out[i: i + 2] = synthesis_rings(plan, streams[i: i + 2])
    return out
