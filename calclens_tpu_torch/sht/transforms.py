"""Spherical-harmonic transforms of the full-sky plane step.

Port of calclens_tpu/sht/transforms.py on one device (the reference's
map2alm_transpose_mpi.c and alm2allmaps_transpose_mpi.c):

  * ring DFTs (rings.py, czt.py): for the analysis the bucketed belt-rfft +
    cap chirp-Z stage, or the uniform chirp-Z over all rings; for the
    synthesis the ring stage that plan.synthesis_rings_mode names;
  * north/south ring pairs folded into J = 2*nside even/odd combinations;
  * the Legendre sweeps in sht/legendre.py, chosen by the plan's selectors:
    K1 or K4 (analysis), K2 or K3 (synthesis, with derivatives or the
    potential alone) for CUDA tensors, their plain twins for CPU tensors;
  * the six covariant outputs phi, d_theta, d_phi/sin and the covariant
    second derivatives, with the cot corrections of
    alm2allmaps_transpose_mpi.c:1094-1147 applied in ring-row space;
  * the j-block streamed synthesis (_alm2allmaps_streamed): per block of
    ring pairs the Legendre synthesis on that window of columns, then the
    ring DFTs of only its rows, written as contiguous pixel segments of
    the RING maps, so one block's working set is alive at a time (the
    reference bounds the same memory by 20-ring chunks,
    alm2allmaps_transpose_mpi.c:76,256-261).

On a mesh (plan.mesh) the transforms run sharded, with the collectives of
parallel/sharding.py between the stages (the reference's MPI transposes,
map2alm_transpose_mpi.c:317-381): a map is this rank's block of RING
pixels (plan.pix_bounds), alm this rank's m columns (plan.m0 .. plan.m1).
The analysis redistributes the block to the pixels of the rank's ring rows,
runs their ring DFTs (analysis_ring_rows: rows in, rows out), transposes
ring rows -> m columns, folds the pairs and runs K1 (or K4) on the rank's m
rows; the synthesis runs K2 (or K3) on the rank's m rows, transposes m ->
ring rows (per j-block when streamed), runs the ring DFTs of the rank's
rows and redistributes their pixels to the rank's block.  The kernels are
the one-device kernels on a block of m rows (their m0 argument).

Each ring stage (analysis_rings, synthesis_rings, synth_ring_rows,
analysis_ring_rows) is a RINGS span of the plane step (utils/profile.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import legendre
from .czt import TableCache, czt_blocked
from .plan import SYNTHESIS_RINGS_MODES, SHTPlan, phase_table, pix2ring_index
from .rings import _next_fft_len, belt_rows
from ..utils.profile import count, spanned

# j-blocks of the streamed synthesis per HEALPix order, the H100's own; an
# order below 13 takes 1 (unstreamed), an order above 13 takes 13's.
# chip_smoke.py phase 15 times every count at orders 10-13 and checks that
# the default is within 15 % of the fastest (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §6 has each call's times).  Below order 13 the synthesis stays
# unstreamed: in every call it was the fastest, or within the noise of the
# fastest count.  Order 13, where it does not fit, takes 32.
SYNTH_STREAM_BLOCKS = {13: 32}
# rows per chirp-Z of a streamed cap range: at most the JAX package's
# min(ring_block, 1024), and so few that one work array of the k streams
# holds at most STREAM_CZT_ELEMS complex values (at order 13, L = 65536 and
# six streams: 85 rows, 256 MB per array in complex64)
STREAM_CZT_ROWS = 1024
STREAM_CZT_ELEMS = 1 << 25


@spanned("RINGS")
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
    return plan.times_ring_phase(
        G.reshape(F.shape[:-2] + (plan.nrings_pad, plan.nm)), -1,
        inplace=True)


@spanned("RINGS")
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
    Y = plan.times_ring_phase(Q, +1, mfold=True)
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
    re, im = kernel(*legendre.analysis_inputs(plan, E, O, plan.m0), plan.nl,
                    m0=plan.m0)
    return torch.complex(re, im).T.contiguous().to(plan.cdtype)


def synthesis_streams(plan: SHTPlan, alm, derivs: bool = True):
    """The planes the synthesis kernel reads, from alm [nl, nm]: K2's
    stream planes (legendre.mx_prep), or K3's two a-planes."""
    rows = plan.m1 - plan.m0
    if plan.synth_kernel == "k3":
        return legendre.mx_prep(plan.nl, rows, alm, plan.dtype,
                                derivs=False, m0=plan.m0)
    if plan.synth_kernel != "k2":
        raise ValueError(f"synth_kernel {plan.synth_kernel!r}: expected "
                         "'k2' or 'k3'")
    return legendre.mx_prep(plan.nl, rows, alm, plan.dtype, derivs,
                            m0=plan.m0)


def legendre_synthesis(plan: SHTPlan, alm, derivs: bool = True,
                       streams=None):
    """alm [nl, nm] complex -> (qN, qS), each [3, nm, J] complex (phi,
    d_theta, d_theta_theta) when derivs, else [1, nm, J] (phi): kernel K2
    (plan.synth_kernel "k2") or K3 ("k3") for CUDA tensors, its twin for CPU
    tensors (calclens_tpu/sht/transforms.py::_legendre_synth_dispatch).  K2
    and K3 leave 0 beyond their per-tile turning-point cutoff (plan.mcut),
    where lambda is below float32 significance; the JAX package cuts its
    streamed synthesis on ring windows by the same rule (_geo_view and
    _legendre_synth_dispatch).  plan may be a RingPairWindow (J its
    columns); streams, synthesis_streams(plan, alm, derivs) made once for
    all the windows of a streamed synthesis, replaces alm."""
    if streams is None:
        streams = synthesis_streams(plan, alm, derivs)
    mcut = plan.mcut(legendre.SYNTH_TILE_J)
    m0, m1 = plan.m0, plan.m1
    rows = None if plan.mesh is None else torch.arange(m0, m1,
                                                       device=plan.device)
    if plan.synth_kernel == "k3":
        c = legendre.synth_vpu_columns(*streams, plan.cth, plan.sth,
                                       plan.cot, plan.inv_sth, derivs, mcut,
                                       m0=m0)
        del streams
        return legendre.q_from_buckets(plan, c, m=rows)
    c = legendre.synth_columns(streams, plan.cth, plan.ln_sth,
                               plan.logc[m0:m1], mcut, m0=m0)
    del streams
    return legendre.q_from_columns(plan, c, m=rows)


def map2alm(plan: SHTPlan, m):
    """RING map [npix] -> alm [nl, nm] complex (l-major; entries m > l are 0),

    alm = sum_rings w_r lambda_lm(theta_r) G_m(r) with the reference's
    quadrature weights (map2alm_transpose_mpi.c:110-124).  On a mesh: this
    rank's pixel block [b - a] -> its alm columns [nl, m1 - m0]."""
    if plan.mesh is not None:
        return _map2alm_mesh(plan, m)
    G = analysis_rings(plan, m)
    E, O = fold_pairs(plan, G)
    del G
    return legendre_analysis(plan, E, O)


def alm2map(plan: SHTPlan, alm):
    """alm [nl, nm] -> RING map [npix]: the potential alone (the
    multigrid path's synthesis, calclens_tpu/sht/transforms.py::alm2map).
    On a mesh: this rank's alm columns -> its pixel block."""
    if plan.mesh is not None:
        qN, qS = legendre_synthesis(plan, alm, False)
        seg = _synth_mesh_rows(plan, qN, qS, 0, plan.J, None, 1)
        return plan.mesh.repartition(seg, plan.ring_pix_bounds,
                                     plan.pix_bounds)[0]
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
    count("host_sync", 2)    # the two host -> device copies
    gp = qphi * im * inv
    return torch.stack([
        qphi,                                    # pot
        qth,                                     # d_theta
        gp,                                      # d_phi / sin
        qthth,                                   # d_theta_theta
        qth * im * inv - cot * gp,               # d_theta_phi cov
        -(qphi * m2) * (inv * inv) + cot * qth,  # d_phi_phi cov
    ])


def alm2allmaps(plan: SHTPlan, alm, out=None):
    """alm -> [6, npix]: phi, d_theta, d_phi, d_theta_theta, d_theta_phi,
    d_phi_phi, the covariant components on the orthonormal (e_theta,
    e_phi) basis (alm2allmaps_transpose_mpi.c:121-131, 1080-1147), written
    into `out` ([6, npix], rows contiguous) when given.  Streamed over
    synth_stream_blocks(plan) j-blocks when that is above 1.  On a mesh:
    this rank's alm columns -> its pixel block [6, b - a]."""
    if plan.mesh is not None:
        return _alm2allmaps_mesh(plan, alm, out)
    if out is None:
        out = torch.empty((6, plan.npix), dtype=plan.dtype,
                          device=alm.device)
    nblk = synth_stream_blocks(plan)
    if nblk > 1:
        return _alm2allmaps_streamed(plan, alm, nblk, out)
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
    for i in range(0, 6, 2):
        out[i: i + 2] = synthesis_rings(plan, streams[i: i + 2])
    return out


# ----------------------------------------------------------------------------
# the j-block streamed synthesis (calclens_tpu/sht/transforms.py:542-1087)
# ----------------------------------------------------------------------------

def synth_stream_blocks(plan) -> int:
    """j-blocks of the streamed synthesis (1: unstreamed): plan.synth_stream
    when set (CALCLENS_SYNTH_STREAM sets it when the plan is built), else
    SYNTH_STREAM_BLOCKS of the order, 1 where it names none
    (calclens_tpu/sht/transforms.py::_synth_stream_blocks, whose per-order
    counts are the TPU's)."""
    nblk = getattr(plan, "synth_stream", None)
    if nblk is not None:
        return int(nblk)
    return SYNTH_STREAM_BLOCKS.get(min(plan.order, max(SYNTH_STREAM_BLOCKS)),
                                   1)


def rows_phase(plan: SHTPlan, r0: int, r1: int):
    """(2 - delta_m0) exp(i m phi0_r) [r1 - r0, nm] of the rings [r0, r1):
    synthesis_phase()'s rows, formed for these rows alone
    (calclens_tpu/sht/transforms.py::_rows_phase, times the m fold)."""
    return phase_table(plan.m_int, plan.n_dev[r0:r1], plan.shift_dev[r0:r1],
                       +1, plan.dtype, mfold=True)


def ring_subranges(plan: SHTPlan, r0: int, r1: int):
    """[r0, r1) split into its maximal cap / belt / cap ring ranges."""
    belt = np.flatnonzero(plan.n_host[r0:r1] == plan.P)
    bounds = ([r0, r0 + int(belt[0]), r0 + int(belt[-1]) + 1, r1]
              if len(belt) else [r0, r1])
    return [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def cap_czt_shape(plan: SHTPlan, a: int, b: int):
    """(nmax, M, L) of the cap ring range [a, b)'s chirp-Z: its longest
    ring, the modes it reads (the turning-point cutoff on its largest
    sin theta, at granularity 256: the columns beyond are float32 zeros
    out of the Legendre sweep) and the padded FFT length
    (calclens_tpu/sht/transforms.py::_cap_czt_shape)."""
    nmax = int(plan.n_host[a:b].max())
    M = m_cutoff(plan.nl - 1, float(plan.sth_ring[a:b].max()), plan.nm,
                 granularity=256)
    return nmax, M, _next_fft_len(nmax + M)


@spanned("RINGS")
def synth_ring_rows(plan: SHTPlan, S, r0: int, r1: int, out=None,
                    cache=None):
    """S [k, r1 - r0, nm] complex q values of the rings [r0, r1) -> their
    pixels [k, startpix[r1] - startpix[r0]], contiguous in the RING map,
    written into `out` when given
    (calclens_tpu/sht/transforms.py::_synth_ring_rows).

    The rows take their phases and m fold (rows_phase).  Belt ranges are
    an irfft per row whose output is the pixel run; a cap range is a
    chirp-Z emitting each row's nmax values from its first M modes, in
    blocks of rows (STREAM_CZT_ROWS, STREAM_CZT_ELEMS) with tables for
    those rows, packed into the segment through one index.  The tables go
    to `cache` (a TableCache), by default a new one per call, so none is
    kept: keeping every block's takes 7.25 GiB at order 13 (PERF.md)."""
    k = S.shape[0]
    sp = np.append(plan.startpix[: plan.nrings], plan.npix)
    p0 = int(sp[r0])
    if out is None:
        out = torch.empty((k, int(sp[r1]) - p0), dtype=plan.dtype,
                          device=S.device)
    Y = S * rows_phase(plan, r0, r1)
    if cache is None:
        cache = TableCache(plan.device)
    for a, b in ring_subranges(plan, r0, r1):
        seg = out[:, int(sp[a]) - p0: int(sp[b]) - p0]
        Yp = Y[:, a - r0: b - r0]
        if plan.n_host[a] == plan.P:
            seg.copy_(belt_rows(Yp, plan.P, plan.cdtype))
            continue
        nmax, M, L = cap_czt_shape(plan, a, b)
        rows = max(8, min(STREAM_CZT_ROWS, STREAM_CZT_ELEMS // (k * L)))
        for c0 in range(a, b, rows):
            c1 = min(b, c0 + rows)
            X = czt_blocked(Yp[:, c0 - a: c1 - a, :M], plan.n_host[c0:c1],
                            nmax, L, +1, plan.cdtype, c1 - c0, cache,
                            ("stream", c0, c1), real=True)
            idx = cache.get(("stream_pixels", c0, c1), lambda: pix2ring_index(
                sp[c0:c1] - sp[c0], np.arange(c1 - c0) * nmax,
                int(sp[c1] - sp[c0]), plan.device))
            seg[:, int(sp[c0] - sp[a]): int(sp[c1] - sp[a])] = \
                X.reshape(k, -1).index_select(1, idx)
            del X
    return out


def _alm2allmaps_streamed(plan: SHTPlan, alm, nblk: int, out):
    """alm2allmaps over nblk j-blocks of ring pairs
    (calclens_tpu/sht/transforms.py::_alm2allmaps_streamed, whose
    host-streamed form alm2allmaps_host_streamed is what an eager loop
    does): the synthesis planes are made once; per block, the Legendre
    synthesis on its window of columns, the covariant streams of its north
    rows (rings j0..j1-1) and their ring synthesis written in place into
    `out`, then the same for its south rows (rings nrings-j1s..nrings-j0-1,
    reversed; the equator's pair j = J-1 has no south ring).  Each block's
    temporaries are freed before the next block starts."""
    J, nrings = plan.J, plan.nrings
    if J % nblk:
        raise ValueError(f"{nblk} j-blocks do not divide J = {J}")
    jb = J // nblk
    sp = np.append(plan.startpix[:nrings], plan.npix)
    streams = synthesis_streams(plan, alm, True)

    def rows(q, r0, r1):
        S = _streams_from_q_rows(plan, q[0], q[1], q[2],
                                 plan.sth_ring[r0:r1], plan.cot_ring[r0:r1])
        synth_ring_rows(plan, S, r0, r1, out[:, int(sp[r0]): int(sp[r1])])

    for j0 in range(0, J, jb):
        j1 = j0 + jb
        qN, qS = legendre_synthesis(plan.window(j0, j1), None, True,
                                    streams=streams)
        rows(qN.transpose(1, 2), j0, j1)
        del qN
        j1s = min(j1, J - 1)
        if j1s > j0:
            rows(qS[:, :, : j1s - j0].flip(2).transpose(1, 2),
                 nrings - j1s, nrings - j0)
        del qS
    return out


# ----------------------------------------------------------------------------
# the transforms on a mesh (calclens_tpu/sht/transforms.py with plan.spec)
# ----------------------------------------------------------------------------

@spanned("RINGS")
def analysis_ring_rows(plan: SHTPlan, seg, r0: int, r1: int, cache=None):
    """seg [..., startpix[r1] - startpix[r0]] the pixels of the rings [r0,
    r1) -> G [..., r1 - r0, nm] = e^{-i m phi0_r} DFT_{n_r}(x_r)[m mod n_r]:
    the analysis ring stage on those rows alone (calclens_tpu/sht/
    transforms.py::_czt_rows_sharded: rows in, rows out).  Belt ranges take
    an rfft per row, cap ranges a chirp-Z emitting their first K modes (the
    turning-point cutoff on the range's largest sin theta, as the v2
    stage's cap groups; 0 beyond), in blocks of rows as synth_ring_rows.
    Tables go to `cache` (a new TableCache by default)."""
    lead = seg.shape[:-1]
    k = int(np.prod(lead)) if lead else 1
    nm, P = plan.nm, plan.P
    sp = np.append(plan.startpix[: plan.nrings], plan.npix)
    p0 = int(sp[r0])
    if cache is None:
        cache = TableCache(plan.device)
    G = torch.zeros(lead + (r1 - r0, nm), dtype=plan.cdtype,
                    device=seg.device)
    for a, b in ring_subranges(plan, r0, r1):
        x = seg[..., int(sp[a]) - p0: int(sp[b]) - p0]
        if plan.n_host[a] == P:
            Fh = torch.fft.rfft(x.reshape(lead + (b - a, P)), dim=-1)
            H = P // 2 + 1
            if nm <= H:
                G[..., a - r0: b - r0, :] = Fh[..., :nm]
            else:
                G[..., a - r0: b - r0, :H] = Fh
                G[..., a - r0: b - r0, H:] = torch.conj(
                    Fh[..., P - nm + 1: P - H + 1].flip(-1))
            continue
        nmax = int(plan.n_host[a:b].max())
        K = m_cutoff(plan.nl - 1, float(plan.sth_ring[a:b].max()), nm,
                     granularity=256)
        L = _next_fft_len(nmax + K - 1)
        rows = max(8, min(STREAM_CZT_ROWS, STREAM_CZT_ELEMS // (k * L)))
        for c0 in range(a, b, rows):
            c1 = min(b, c0 + rows)

            def build(c0=c0, c1=c1):
                j = torch.arange(nmax, device=plan.device)[None, :]
                n = torch.as_tensor(plan.n_host[c0:c1],
                                    device=plan.device)[:, None]
                st = torch.as_tensor(sp[c0:c1] - sp[c0],
                                     device=plan.device)[:, None]
                mask = j < n
                return torch.where(mask, st + j, 0).reshape(-1), mask

            idx, mask = cache.get(("analysis_rows", c0, c1), build)
            xs = x[..., int(sp[c0] - sp[a]): int(sp[c1] - sp[a])]
            X = torch.where(mask, xs.index_select(-1, idx).reshape(
                lead + mask.shape), 0.0)
            G[..., c0 - r0: c1 - r0, :K] = czt_blocked(
                X, plan.n_host[c0:c1], K, L, -1, plan.cdtype, c1 - c0, cache,
                ("analysis_rows", c0, c1))
            del X
    return G.mul_(phase_table(plan.m_int, plan.n_dev[r0:r1],
                              plan.shift_dev[r0:r1], -1, plan.dtype))


def _map2alm_mesh(plan: SHTPlan, m):
    """map2alm on a mesh: pixel block -> the pixels of the rank's ring rows
    (repartition), their ring DFTs, the ring -> m transpose, the pair fold
    and the Legendre analysis of the rank's m rows."""
    mesh = plan.mesh
    seg = mesh.repartition(m, plan.pix_bounds, plan.ring_pix_bounds)
    G = analysis_ring_rows(plan, seg, plan.r0, plan.r1, plan.tables)
    del seg
    Gm = mesh.rings_to_m(G, plan.ring_bounds, plan.m_bounds)
    del G
    E, O = fold_pairs(plan, Gm)
    del Gm
    return legendre_analysis(plan, E, O)


def mesh_stream_blocks(nblk: int, J: int, n: int) -> int:
    """j-blocks of the streamed synthesis on n ranks: halved until
    J % nblk == 0 and (J / nblk) % n == 0, as the JAX package's mesh
    branch of _synth_stream_blocks does."""
    while nblk > 1 and (J % nblk or (J // nblk) % n):
        nblk //= 2
    return max(1, nblk)


def _synth_mesh_rows(plan: SHTPlan, qN, qS, j0: int, j1: int, seg, k: int,
                     cache=None):
    """The ring side of the synthesis on a mesh for the ring pairs [j0, j1):
    qN, qS [k', m1 - m0, j1 - j0] (this rank's m rows; k' = 3 with
    derivatives, 1 without) -> the north rows j0..j1-1 and the south rows
    nrings-j1s..nrings-j0-1 (j1s = min(j1, J - 1)) transposed m -> ring rows
    (Mesh.m_to_rings), and of those that are this rank's, the k streams
    (the six covariant ones for k = 6, the potential for k = 1) synthesised
    into `seg`, the pixels of the rank's ring rows ([k, ...], made when
    None).  Returns seg."""
    mesh = plan.mesh
    sp = np.append(plan.startpix[: plan.nrings], plan.npix)
    q0 = int(sp[plan.r0])
    if seg is None:
        seg = torch.zeros((k, int(sp[plan.r1]) - q0), dtype=plan.dtype,
                          device=plan.device)
    j1s = min(j1, plan.J - 1)
    parts = [(qN.transpose(1, 2), j0)]
    if j1s > j0:
        parts.append((qS[:, :, : j1s - j0].flip(2).transpose(1, 2),
                      plan.nrings - j1s))
    for Q, row0 in parts:
        Qr, (lo, hi) = mesh.m_to_rings(Q, row0, plan.ring_bounds,
                                       plan.m_bounds)
        if hi <= lo:
            continue
        if k == 6:
            S = _streams_from_q_rows(plan, Qr[0], Qr[1], Qr[2],
                                     plan.sth_ring[lo:hi],
                                     plan.cot_ring[lo:hi])
        else:
            S = Qr
        del Qr
        synth_ring_rows(plan, S, lo, hi,
                        seg[:, int(sp[lo]) - q0: int(sp[hi]) - q0], cache)
        del S
    return seg


def _alm2allmaps_mesh(plan: SHTPlan, alm, out=None):
    """alm2allmaps on a mesh: K2 (or K3) on the rank's m rows, per j-block
    when synth_stream_blocks(plan) is above 1 (mesh_stream_blocks), the m
    -> ring transpose and ring stage of the rank's rows (_synth_mesh_rows),
    then the rank's ring pixels redistributed to its pixel block."""
    mesh = plan.mesh
    nblk = mesh_stream_blocks(synth_stream_blocks(plan), plan.J, mesh.size)
    jb = plan.J // nblk
    if nblk == 1:
        qN, qS = legendre_synthesis(plan, alm, True)
        seg = _synth_mesh_rows(plan, qN, qS, 0, plan.J, None, 6,
                               plan.tables)
        del qN, qS
    else:
        streams = synthesis_streams(plan, alm, True)
        seg = None
        for j0 in range(0, plan.J, jb):
            qN, qS = legendre_synthesis(plan.window(j0, j0 + jb), None, True,
                                        streams=streams)
            seg = _synth_mesh_rows(plan, qN, qS, j0, j0 + jb, seg, 6)
            del qN, qS
        del streams
    blk = mesh.repartition(seg, plan.ring_pix_bounds, plan.pix_bounds)
    if out is None:
        return blk
    out.copy_(blk)
    return out
