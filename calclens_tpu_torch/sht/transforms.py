"""Spherical-harmonic transforms of the full-sky plane step.

Port of calclens_tpu/sht/transforms.py (unstreamed single-device path; the
reference's map2alm_transpose_mpi.c and alm2allmaps_transpose_mpi.c):

  * ring DFTs (rings.py, czt.py): for the analysis the bucketed belt-rfft +
    cap chirp-Z stage, or the uniform chirp-Z over all rings; for the
    synthesis the ring stage that plan.synthesis_rings_mode names;
  * north/south ring pairs folded into J = 2*nside even/odd combinations;
  * the Legendre sweeps in sht/legendre.py, chosen by the plan's selectors:
    K1 or K4 (analysis), K2 or K3 (synthesis, with derivatives or the
    potential alone) for CUDA tensors, their plain twins for CPU tensors;
  * the six covariant outputs phi, d_theta, d_phi/sin and the covariant
    second derivatives, with the cot corrections of
    alm2allmaps_transpose_mpi.c:1094-1147 applied in ring-row space.
"""

from __future__ import annotations

import numpy as np
import torch

from . import legendre
from .czt import czt_blocked
from .plan import SYNTHESIS_RINGS_MODES, SHTPlan


def analysis_rings(plan: SHTPlan, maps):
    """RING map(s) [..., npix] -> G_m per ring [..., nrings_pad, nm],

    G[r, m] = sum_p map(r, p) e^{-i m phi_rp} = e^{-i m phi0_r}
    DFT_{n_r}(x_r)[m mod n_r]:

    by the bucketed stage of rings.py (plan.use_rings_v2, the default), or
    by the uniform chirp-Z over all rings and an m mod n gather."""
    if plan.use_rings_v2:
        return plan.ring_stage().analysis(maps)
    X = plan.map_to_rings(maps)  # [..., nrings_pad, P]
    F = czt_blocked(X, plan.n_host, plan.P, plan.L, -1, plan.cdtype,
                    plan.ring_block, plan.tables, "uniform")

    def mmod():
        r = torch.arange(plan.nrings_pad, device=plan.device)[:, None]
        m = plan.m_int[None, :] % plan.n_dev[:, None]
        return (r * plan.P + m).to(torch.int32).reshape(-1)

    idx = plan.tables.get(("m_mod_n",), mmod)
    G = F.reshape(F.shape[:-2] + (-1,)).index_select(-1, idx)
    return G.reshape(F.shape[:-2] + (plan.nrings_pad, plan.nm)) \
        * plan.ring_phase(-1)


def synthesis_rings(plan: SHTPlan, Q):
    """q_m per ring [..., nrings_pad, nm] -> RING map(s) [..., npix],

    map(r, p) = Re sum_m (2 - delta_m0) q_m e^{i m phi_rp},

    by the ring stage plan.synthesis_rings_mode names (plan.py):
    "uniform", one chirp-Z over all rings (one shape for every ring, in row
    blocks of plan.ring_block); "v2", the belt irfft with the cap chirp-Zs
    of rings.py.  Neither mode reads Q's padding rows."""
    mode = plan.synthesis_rings_mode
    if mode not in SYNTHESIS_RINGS_MODES:
        raise ValueError(f"synthesis_rings_mode {mode!r}: expected one of "
                         f"{SYNTHESIS_RINGS_MODES}")
    Y = Q * plan.synthesis_phase()
    if mode == "v2":
        return plan.ring_stage().synthesis(Y)
    X = czt_blocked(Y, plan.n_host, plan.P, plan.L, +1, plan.cdtype,
                    plan.ring_block, plan.tables, "uniform", real=True)
    del Y
    return plan.rings_to_map(X)


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
    [nl, nm] complex (entries m > l are 0): kernel K1 (plan.analysis_kernel
    "k1") or K4 ("k4") for CUDA tensors, its twin for CPU tensors."""
    kernel = {"k1": legendre.analysis_columns,
              "k4": legendre.analysis_dot_columns}.get(plan.analysis_kernel)
    if kernel is None:
        raise ValueError(f"analysis_kernel {plan.analysis_kernel!r}: "
                         "expected 'k1' or 'k4'")
    re, im = kernel(*legendre.analysis_inputs(plan, E, O), plan.nl)
    return torch.complex(re, im).T.contiguous().to(plan.cdtype)


def legendre_synthesis(plan: SHTPlan, alm, derivs: bool = True):
    """alm [nl, nm] complex -> (qN, qS), each [3, nm, J] complex (phi,
    d_theta, d_theta_theta) when derivs, else [1, nm, J] (phi): kernel K2
    (plan.synth_kernel "k2") or K3 ("k3") for CUDA tensors, its twin for CPU
    tensors (calclens_tpu/sht/transforms.py::_legendre_synth_dispatch).  K2
    and K3 leave 0 beyond their per-tile turning-point cutoff (plan.mcut),
    where lambda is below float32 significance; the JAX package cuts its
    streamed synthesis on ring windows by the same rule (_geo_view and
    _legendre_synth_dispatch)."""
    if plan.synth_kernel == "k3":
        a_re, a_im = legendre.mx_prep(plan.nl, plan.nm, alm, plan.dtype,
                                      derivs=False)
        c = legendre.synth_vpu_columns(a_re, a_im, plan.cth, plan.sth,
                                       plan.cot, plan.inv_sth, derivs,
                                       plan.mcut(legendre.SYNTH_TILE_J))
        del a_re, a_im
        return legendre.q_from_buckets(plan, c)
    if plan.synth_kernel != "k2":
        raise ValueError(f"synth_kernel {plan.synth_kernel!r}: expected "
                         "'k2' or 'k3'")
    streams = legendre.mx_prep(plan.nl, plan.nm, alm, plan.dtype, derivs)
    c = legendre.synth_columns(streams, plan.cth, plan.ln_sth, plan.logc,
                               plan.mcut(legendre.SYNTH_TILE_J))
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


def alm2map(plan: SHTPlan, alm):
    """alm [nl, nm] -> RING map [npix]: the potential alone (the
    multigrid path's synthesis, calclens_tpu/sht/transforms.py::alm2map)."""
    qN, qS = legendre_synthesis(plan, alm, False)
    Q = unfold_pairs(plan, qN[0], qS[0])
    del qN, qS
    return synthesis_rings(plan, Q[None])[0]


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
    # the six synthesis ring stages run in pairs to bound peak memory, each
    # pair written in place into the one output buffer
    out = torch.empty((6, plan.npix), dtype=plan.dtype, device=alm.device)
    for i in range(0, 6, 2):
        out[i: i + 2] = synthesis_rings(plan, streams[i: i + 2])
    return out
