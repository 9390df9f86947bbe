"""The Legendre sweeps of the SHT: CUDA kernel wrappers and plain twins.

Analysis, alm[l, m] = sum_j lambda_lm(theta_j) S_{l mod 2}[m, j]:
  * K1 (csrc/legendre_analysis.cu; replaces calclens_tpu/sht/
    pallas_legendre.py::_analysis_kernel), the default;
  * K4 (csrc/legendre_analysis_dot.cu; replaces pallas_legendre.py::
    _analysis_dot_kernel), the same function by another route: lambda is
    stored for a block of degrees and then contracted over the rings.
Synthesis, sum_l lambda_lm(theta_j) s(l, m) per ring pair:
  * K2 (csrc/legendre_synth.cu; replaces pallas_legendre_mx.py::
    _synth_mx_kernel), the default: 16 raw columns with derivatives (the
    d_theta recurrence summed by parts), or 4 for the potential alone, 0
    beyond the per-tile turning-point cutoff;
  * K3 (csrc/legendre_synth_vpu.cu; replaces pallas_legendre.py::
    _synth_kernel): l-parity buckets of a lambda, lambda' and lambda''
    formed per degree, with lambda_mm seeded by a chain of products (a
    pre-pass on the card walks it once per ring pair), 0 beyond K2's
    per-tile cutoff.

Each kernel has a plain PyTorch twin here: a Python loop over l on
[rows, J] tensors that computes the kernel's own math (the diagonal seed,
the 2^64 scale counter, the per-j-tile turning-point cutoffs of K1-K4)
with the same float32 roundings, op for op, as the kernels' recurrence
(csrc/legendre_common.cuh): near the poles the recurrence amplifies a rounding difference by up to ~1/sin(theta), so only an
evaluation that rounds alike can be held to float32 accuracy.  A twin
computes every m row by default; the twins of K1-K4 take `m` (an
int64 tensor of the m value of each input row) to compute some rows only,
which is how a large problem's kernel output is checked row by row.
A wrapper takes its twin only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.  The twins run in any float dtype, the
kernels in float32 only.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext

_TH_BIG = 2.0**32
_RESC = 2.0**-64
_LOG2E = 1.4426950408889634
_HALF_LN_4PI = 1.2655121234846454  # 0.5 * ln(4 pi)
_Y00 = 0.28209479177387814  # lambda_00 = 1 / sqrt(4 pi)

# rings per analysis block: K1's and K4's tile, and the unit of their m cutoff
ANALYSIS_TILE_J = 512
# rings per warp of K2 and K3: the unit of their m cutoff
SYNTH_TILE_J = 128
# degrees whose lambda K4 stores before each contraction
DOT_BLOCK_L = 16
# degrees between two checkpoints of K3's seed pre-pass (kSeedSeg in
# csrc/legendre_synth_vpu.cu)
SEED_SEGMENT = 256


# ----------------------------------------------------------------------------
# shared geometry and recurrence pieces
# ----------------------------------------------------------------------------

def logc_table(nm: int, dtype, device) -> torch.Tensor:
    """C[m] = 0.5 * ln((2m+1)!!/(2m)!!) (the log of the diagonal seed's
    double-factorial ratio), evaluated in float64 then cast."""
    m = np.arange(nm, dtype=np.float64)
    c = np.concatenate(
        [[0.0], 0.5 * np.cumsum(np.log((2.0 * m[1:] + 1.0) / (2.0 * m[1:])))])
    return torch.as_tensor(c[:nm], dtype=dtype, device=device)


def _m_rows(m, rows: int, device):
    return (torch.arange(rows, device=device) if m is None
            else torch.as_tensor(m, device=device).long())


def _seed(logc, mf, ln_sth):
    """Direct diagonal seed lambda_mm = stored * 2^(64 k), stored in
    [2^-32, 2^32): [rows, J] values and int32 scale counters.  A ceil-based
    window would give k = +1 where lambda_mm > 1 (near the equator at large
    m) and the scale cutoff would then drop legitimate values."""
    log2lam = (logc[:, None] + mf[:, None] * ln_sth[None, :]
               - _HALF_LN_4PI) * _LOG2E
    kf = torch.floor((log2lam + 32.0) * (1.0 / 64.0))
    return torch.exp2(log2lam - 64.0 * kf), kf.to(torch.int32)


def chain_seed(m, sth):
    """K3's diagonal seed: lambda_00 = 1/sqrt(4 pi), then
    seed <- (seed sin theta) sqrt((2l+3)/(2l+2)) for l = 0, 1, ..., with a
    2^64 rescale (and the scale counter down by one) whenever the seed
    falls below 2^-64.  Returns lambda_mm for the rows' m values as [rows, J]
    values and int32 counters."""
    m = torch.as_tensor(m).long()
    dt, dev = sth.dtype, sth.device
    seed = torch.full_like(sth, _Y00)
    k = torch.zeros(sth.shape, dtype=torch.int32, device=dev)
    rows = {}
    wanted = set(m.tolist())
    for l in range(int(m.max()) + 1):
        if l in wanted:
            rows[l] = (seed, k)
        seed, k = _chain_step(seed, k, sth, _chain_factor(l, dt, dev))
    return (torch.stack([rows[v][0] for v in m.tolist()]),
            torch.stack([rows[v][1] for v in m.tolist()]))


def _chain_factor(l: int, dt, dev):
    """sqrt((2l+3)/(2l+2)) as the kernels round it; tensor / tensor: a
    scalar division would go through a reciprocal."""
    lf = float(l)
    return torch.sqrt(torch.full((), 2.0 * lf + 3.0, dtype=dt, device=dev)
                      / torch.full((), 2.0 * lf + 2.0, dtype=dt, device=dev))


def _chain_step(seed, k, sth, f):
    nxt = seed * sth * f
    under = nxt < _RESC
    return torch.where(under, nxt * 2.0**64, nxt), k - under.to(torch.int32)


def chain_seed_segmented(sth, nm: int, seg: int):
    """chain_seed of every m < nm as K3's seed pre-pass computes it, for
    the tests: one walk of the chain keeps (value, counter) at every m
    that is a multiple of `seg`, then each segment is walked again from its
    checkpoint.  The first walk takes the pre-pass producers' form on rings
    with 2^-40 <= sin theta <= 1: w = v 2^Y, v the chain without rescales
    and Y the sum of the exponent shifts y, stepped as w <- (w (s 2^y)) f
    with y set from the exponent of w two steps back; the counter is the
    running max of floor((-E(v) - 1) / 64) with E(v) = E(w) - Y; other rings
    walk chain_seed's steps.  float32 sth; returns ([nm, J] values, [nm, J]
    int32 counters), bit for bit chain_seed's."""
    if sth.dtype != torch.float32:
        raise TypeError(f"chain_seed_segmented: float32 only, got {sth.dtype}")
    dev = sth.device
    i32 = torch.int32

    def bexp(x):
        return x.view(i32) >> 23

    scaled = (sth >= 2.0**-40) & (sth <= 1.0)
    s = torch.where(scaled, sth, torch.ones_like(sth))
    l2 = torch.log2(s)
    d1, d2, d3 = (torch.round(k * l2).to(i32) for k in (1.0, 2.0, 3.0))
    w = torch.full_like(sth, _Y00)
    Y = torch.zeros(sth.shape, dtype=i32, device=dev)
    c = torch.zeros_like(Y)
    e2 = e1 = bexp(w)
    y2, y1 = d1 - d2, d2 - d3
    v = torch.full_like(sth, _Y00)
    k = torch.zeros_like(Y)
    marks = []
    for l in range(nm):
        if l % seg == 0:
            value = (w.view(i32) + ((64 * c - Y) << 23)).view(torch.float32)
            marks.append((torch.where(scaled, value, v),
                          torch.where(scaled, -c, k)))
        f = _chain_factor(l, sth.dtype, dev)
        y = 127 - d3 - e2 - y2 - y1
        wn = (w * (s * ((y + 127) << 23).view(torch.float32))) * f
        Y = Y + y
        c = torch.maximum(c, (Y + 126 - bexp(wn)) >> 6)
        e2, e1, y2, y1, w = e1, bexp(w), y1, y, wn
        v, k = _chain_step(v, k, sth, f)
    vals, cnts = [], []
    for g, (v, k) in enumerate(marks):
        for l in range(g * seg, min(nm, (g + 1) * seg)):
            vals.append(v)
            cnts.append(k)
            v, k = _chain_step(v, k, sth, _chain_factor(l, sth.dtype, dev))
    return torch.stack(vals), torch.stack(cnts)


def _coeffs(l: int, mf):
    """Recurrence coefficients a_lm, b_lm over the m vector.  Both
    divisions are tensor / tensor: PyTorch evaluates `scalar / tensor` and,
    on CUDA, `tensor / scalar` through a reciprocal, which rounds
    differently from the kernels' division."""
    lf = float(l)
    den = torch.clamp((lf - mf) * (lf + mf), min=1.0)
    num = torch.full_like(den, (2.0 * lf - 1.0) * (2.0 * lf + 1.0))
    bnum = torch.clamp((lf - 1.0 - mf) * (lf - 1.0 + mf), min=0.0)
    bden = torch.full_like(bnum, max((2.0 * lf - 3.0) * (2.0 * lf - 1.0), 1.0))
    return torch.sqrt(num / den), torch.sqrt(bnum / bden)


class _Recurrence:
    """State of the scaled lambda recurrence over all (row, j): step(l)
    returns lambda_lm(theta_j) (exactly 0 for m > l and below 2^-64 of the
    stored scale) of the rows n = active(l): [n, J], lambda_{l-1,m} is then
    pp[:n] * corfac.  When the rows' m ascend, the rows whose recurrence
    has not started (m > l) are the last ones, and a step touches only the
    others: they hold zeros until then, as the full step would leave them
    (the same values, op for op, in half the work over l < nm).  The
    diagonal seed is (values, counters) [rows, J]."""

    def __init__(self, cth, m, seed):
        self.cth = cth[None, :]
        self.m = m[:, None]
        self.mf = m.to(cth.dtype)
        self.seedval, self.seedk = seed
        shape = self.seedval.shape
        self.pp = torch.zeros(shape, dtype=cth.dtype, device=cth.device)
        self.pc = torch.zeros_like(self.pp)
        self.k = torch.zeros(shape, dtype=torch.int32, device=cth.device)
        self._m_host = m.cpu().numpy()
        self._ascending = bool(np.all(np.diff(self._m_host) >= 0))

    def active(self, l: int) -> int:
        """Rows that step(l) computes: those with m <= l when the m ascend
        (a prefix), else all."""
        if self._ascending:
            return int(np.searchsorted(self._m_host, l, side="right"))
        return len(self._m_host)

    def step(self, l: int):
        n = self.n = self.active(l)
        m, pp, pc = self.m[:n], self.pp[:n], self.pc[:n]
        a, b = _coeffs(l, self.mf[:n])
        new = a[:, None] * (self.cth * pc - b[:, None] * pp)
        seed_row = m == l
        inactive = m > l
        new = torch.where(seed_row, self.seedval[:n],
                          torch.where(inactive, 0.0, new))
        prev = torch.where(seed_row | inactive, 0.0, pc)
        k = torch.where(seed_row, self.seedk[:n], self.k[:n])
        big = new.abs() > _TH_BIG
        new = torch.where(big, new * _RESC, new)
        prev = torch.where(big, prev * _RESC, prev)
        k = k + big.to(torch.int32)
        pp.copy_(prev)
        pc.copy_(new)
        self.k[:n] = k
        self.corfac = torch.where(k == 0, 1.0,
                                  torch.where(k == -1, _RESC, 0.0)
                                  ).to(new.dtype)
        return new * self.corfac


def _direct_recurrence(cth, ln_sth, logc, m):
    """The recurrence of K1, K2 and K4: diagonal seed from log2 space."""
    return _Recurrence(cth, m, _seed(logc, m.to(cth.dtype), ln_sth))


def _check_cuda_f32(name, tensors, shapes):
    for key, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {x.device}, not on CUDA")
        want = torch.int32 if key in ("mcut", "seed_k") else torch.float32
        if x.dtype != want:
            raise TypeError(f"{name}: {key} is {x.dtype}; the kernel takes "
                            f"{want} only")
        if tuple(x.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(x.shape)}, "
                             f"expected {shapes[key]}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    dev = {x.device for x in tensors.values()}
    if len(dev) != 1:
        raise ValueError(f"{name}: inputs lie on several devices {dev}")


def _check_problem(name, nm, J, nl):
    if nm == 0 or J == 0 or nl == 0:
        raise ValueError(f"{name}: empty problem nm={nm} J={J} nl={nl}")
    if nm > 65535:
        raise ValueError(f"{name}: nm={nm} exceeds the grid's y dimension")


# ----------------------------------------------------------------------------
# analysis: K1 and K4
# ----------------------------------------------------------------------------

def tile_mcut(sth_host, nl: int, nm: int, tile_j: int):
    """Per-j-tile turning-point cutoff (int32 [ceil(J / tile_j)]): m >=
    mcut contributes nothing to the tile's rings (transforms.m_cutoff at
    granularity 1 on the tile's largest sin theta)."""
    from .transforms import m_cutoff

    sth = np.asarray(sth_host, np.float64)
    return np.array([m_cutoff(nl - 1, float(np.max(sth[t: t + tile_j])), nm,
                              granularity=1)
                     for t in range(0, len(sth), tile_j)], dtype=np.int32)


def analysis_mcut(sth_host, nl: int, nm: int):
    """K1's and K4's cutoff: tile_mcut on their 512-ring tiles."""
    return tile_mcut(sth_host, nl, nm, ANALYSIS_TILE_J)


def synth_mcut(sth_host, nl: int, nm: int):
    """K2's and K3's cutoff: tile_mcut on their 128-ring tiles."""
    return tile_mcut(sth_host, nl, nm, SYNTH_TILE_J)


def _below_cut(mcut, m, J: int, tile_j: int):
    """[rows, J] bool: row m lies below the cutoff of ring j's tile."""
    tile_cut = torch.as_tensor(mcut, device=m.device).long()
    return m[:, None] < tile_cut.repeat_interleave(tile_j)[None, :J]


def _analysis_sources(ere, eim, ore, oim, mcut, m, tile_j):
    """Parity-resolved sources S0 = (m even ? E : O), S1 = (m even ? O : E)
    (re, im) with every (m, j) beyond its ring tile's cutoff zeroed."""
    keep = _below_cut(mcut, m, ere.shape[1], tile_j).to(ere.dtype)
    m_even = (m % 2 == 0)[:, None]
    return (torch.where(m_even, ere, ore) * keep,
            torch.where(m_even, eim, oim) * keep,
            torch.where(m_even, ore, ere) * keep,
            torch.where(m_even, oim, eim) * keep)


def analysis_plain(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl: int,
                   tile_j: int = ANALYSIS_TILE_J, m=None):
    """K1's twin.  E/O planes [nm, J]; cth, ln_sth [J]; logc [nm]; mcut
    int32 [ceil(J / tile_j)].  Returns (alm_re, alm_im), each TRANSPOSED
    [nm, nl] like the kernel's output.  With m, the planes and logc hold
    only those rows, and so does the output."""
    dt, dev = ere.dtype, ere.device
    m = _m_rows(m, ere.shape[0], dev)
    s0r, s0i, s1r, s1i = _analysis_sources(ere, eim, ore, oim, mcut, m,
                                           tile_j)
    rec = _direct_recurrence(cth, ln_sth, logc, m)
    out_re = torch.zeros((nl, len(m)), dtype=dt, device=dev)
    out_im = torch.zeros_like(out_re)
    for l in range(nl):
        lam = rec.step(l)
        n = rec.n
        sr, si = (s1r, s1i) if l % 2 else (s0r, s0i)
        out_re[l, :n] = (lam * sr[:n]).sum(dim=1)
        out_im[l, :n] = (lam * si[:n]).sum(dim=1)
    return out_re.T.contiguous(), out_im.T.contiguous()


def _analysis_launch(name, symbol, ere, eim, ore, oim, cth, ln_sth, logc, mcut,
                     nl, m0=0):
    nm, J = ere.shape
    _check_problem(name, nm, J, nl)
    nt = -(-J // ANALYSIS_TILE_J)
    _check_cuda_f32(
        name,
        dict(ere=ere, eim=eim, ore=ore, oim=oim, cth=cth, ln_sth=ln_sth,
             logc=logc, mcut=mcut),
        dict(ere=(nm, J), eim=(nm, J), ore=(nm, J), oim=(nm, J), cth=(J,),
             ln_sth=(J,), logc=(nm,), mcut=(nt,)))
    alm_re = torch.zeros((nm, nl), dtype=torch.float32, device=ere.device)
    alm_im = torch.zeros_like(alm_re)
    _ext.launch(name, symbol, ere.device, ere.data_ptr(), eim.data_ptr(),
                ore.data_ptr(), oim.data_ptr(), cth.data_ptr(),
                ln_sth.data_ptr(), logc.data_ptr(), mcut.data_ptr(),
                alm_re.data_ptr(), alm_im.data_ptr(), nl, nm, J, int(m0))
    return alm_re, alm_im


def analysis_cuda(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl: int,
                  m0: int = 0):
    """Launch K1 on the tensors' CUDA device and PyTorch's current stream.
    Same contract as analysis_plain, for the rows m = m0, m0 + 1, ...
    (the planes and logc of those rows); float32 only."""
    return _analysis_launch("legendre_analysis", "legendre_analysis_launch",
                            ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl,
                            m0)


def _rows(m0, x):
    """The m values of x's rows when they start at m0 (None: from 0)."""
    return None if not m0 else torch.arange(m0, m0 + x.shape[0],
                                            device=x.device)


def analysis_columns(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl: int,
                     m0: int = 0):
    """K1 wrapper: the kernel for CUDA tensors, the twin for CPU tensors;
    the input rows are m = m0, m0 + 1, ... (a rank's m block)."""
    if ere.device.type == "cpu":
        return analysis_plain(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl,
                              m=_rows(m0, ere))
    return analysis_cuda(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl, m0)


def analysis_dot_plain(ere, eim, ore, oim, cth, ln_sth, logc, mcut,
                       nl: int, tile_j: int = ANALYSIS_TILE_J, m=None):
    """K4's twin: K1's function by K4's route.  The lambda values of a
    block of DOT_BLOCK_L degrees are stored [rows, block, J] and contracted
    over j with one einsum against the four sources (S0, S1) x (re, im);
    each degree then keeps the pair of its l parity.  Same contract as
    analysis_plain."""
    dt, dev = ere.dtype, ere.device
    m = _m_rows(m, ere.shape[0], dev)
    S = torch.stack(_analysis_sources(ere, eim, ore, oim, mcut, m, tile_j),
                    dim=1)  # [rows, 4, J]
    rec = _direct_recurrence(cth, ln_sth, logc, m)
    out_re = torch.zeros((len(m), nl), dtype=dt, device=dev)
    out_im = torch.zeros_like(out_re)
    for l0 in range(0, nl, DOT_BLOCK_L):
        ls = range(l0, min(l0 + DOT_BLOCK_L, nl))
        n = rec.active(ls[-1])  # the rows any degree of the block computes
        lam = torch.zeros((n, len(ls), cth.shape[0]), dtype=dt, device=dev)
        for i, l in enumerate(ls):
            lam[: rec.active(l), i] = rec.step(l)
        R = torch.einsum("rlj,rcj->rlc", lam, S[:n])  # [rows, block, 4]
        odd = torch.tensor([l % 2 == 1 for l in ls], device=dev)[None, :]
        out_re[:n, l0: l0 + len(ls)] = torch.where(odd, R[:, :, 2],
                                                   R[:, :, 0])
        out_im[:n, l0: l0 + len(ls)] = torch.where(odd, R[:, :, 3],
                                                   R[:, :, 1])
    return out_re, out_im


def analysis_dot_cuda(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl: int,
                      m0: int = 0):
    """Launch K4 on the tensors' CUDA device and PyTorch's current stream.
    Same contract as analysis_dot_plain, for the rows m = m0, m0 + 1, ...;
    float32 only."""
    return _analysis_launch("legendre_analysis_dot",
                            "legendre_analysis_dot_launch",
                            ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl,
                            m0)


def analysis_dot_columns(ere, eim, ore, oim, cth, ln_sth, logc, mcut,
                         nl: int, m0: int = 0):
    """K4 wrapper: the kernel for CUDA tensors, the twin for CPU tensors;
    the input rows are m = m0, m0 + 1, ...."""
    if ere.device.type == "cpu":
        return analysis_dot_plain(ere, eim, ore, oim, cth, ln_sth, logc,
                                  mcut, nl, m=_rows(m0, ere))
    return analysis_dot_cuda(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl,
                             m0)


def analysis_inputs(plan, E, O, m0: int = 0):
    """Kernel-ready K1 / K4 inputs from the folded ring-pair sums E, O
    [rows, J] (complex) of the m rows m0, m0 + 1, ...: contiguous
    real/imaginary planes, geometry rows, those rows' seed table and the
    per-tile cutoff (cached on the plan).  No padding: the kernels mask
    the ragged j edge themselves."""
    rdt = plan.dtype
    planes = [x.contiguous() for x in (E.real.to(rdt), E.imag.to(rdt),
                                       O.real.to(rdt), O.imag.to(rdt))]
    logc = plan.logc[m0: m0 + E.shape[0]]
    return (*planes, plan.cth, plan.ln_sth, logc,
            plan.mcut(ANALYSIS_TILE_J))


# ----------------------------------------------------------------------------
# K2: synthesis columns, with derivatives (16) or the potential alone (4)
# ----------------------------------------------------------------------------

def _dfac_rows(nl: int, nm: int, dtype, device, m0: int = 0):
    """d_lm = sqrt((l^2 - m^2)(2l+1)/(2l-1)) for l = 1..nl (the d_theta
    lowering factor) [nl, nm], for m = m0 .. m0 + nm - 1."""
    l = torch.arange(1, nl + 1, dtype=dtype, device=device)[:, None]
    m = torch.arange(m0, m0 + nm, dtype=dtype, device=device)[None, :]
    num = torch.clamp(l * l - m * m, min=0.0) * (2.0 * l + 1.0)
    den = torch.clamp(2.0 * l - 1.0, min=1.0)
    return torch.sqrt(num / den)


def mx_prep(nl: int, nm: int, alm, dtype, derivs: bool = True, m0: int = 0):
    """alm [nl, nm] complex (the columns m = m0 .. m0 + nm - 1) -> the
    TRANSPOSED stream planes [nm, nl]: (a_re, a_im, h_re, h_im) with
    h_l = d_{l+1} a_{l+1} (summation by parts of the d_theta lowering
    recurrence) when derivs, else (a_re, a_im)."""
    ar = alm.real.to(dtype)
    ai = alm.imag.to(dtype)
    if not derivs:
        return tuple(x.T.contiguous() for x in (ar, ai))
    d = _dfac_rows(nl - 1, nm, dtype, alm.device, m0)  # rows l = 1..nl-1
    zero = torch.zeros((1, nm), dtype=dtype, device=alm.device)
    hr = torch.cat([ar[1:] * d, zero])
    hi = torch.cat([ai[1:] * d, zero])
    return tuple(x.T.contiguous() for x in (ar, ai, hr, hi))


def synth_plain(streams, cth, ln_sth, logc, mcut=None, m=None,
                tile_j: int = SYNTH_TILE_J):
    """K2's twin.  streams: the 4 derivative planes or the 2 a-planes of
    mx_prep [rows, nl]; cth, ln_sth [J]; logc [rows]; mcut int32
    [ceil(J / tile_j)] or None (no cutoff).  Returns the raw columns
    [rows, ncol, J], ncol = 16 or 4: the streams {a, l a, h, l(l+1) a} x
    {re, im} (or {a} x {re, im}) summed with weight 1 (first half) and
    (-1)^l (second half); 0 where the row's m is at or beyond the cutoff of
    the ring's tile."""
    a_re, a_im = streams[0], streams[1]
    rows, nl = a_re.shape
    J = cth.shape[0]
    dt, dev = a_re.dtype, a_re.device
    m = _m_rows(m, rows, dev)
    rec = _direct_recurrence(cth, ln_sth, logc, m)
    ns = 8 if len(streams) == 4 else 2
    # even- and odd-l sums of the streams
    acc = torch.zeros((2, ns, rows, J), dtype=dt, device=dev)
    for l in range(nl):
        lam = rec.step(l)
        n = rec.n
        ar, ai = a_re[:n, l], a_im[:n, l]
        if ns == 2:
            s = torch.stack([ar, ai])
        else:
            lf = float(l)
            s = torch.stack([ar, ai, ar * lf, ai * lf, streams[2][:n, l],
                             streams[3][:n, l], ar * (lf * (lf + 1.0)),
                             ai * (lf * (lf + 1.0))])
        # in place: no temporary
        acc[l % 2, :, :n].addcmul_(s[:, :, None], lam[None])
    out = torch.cat([acc[0] + acc[1], acc[0] - acc[1]])  # [ncol, rows, J]
    if mcut is not None:
        out = torch.where(_below_cut(mcut, m, J, tile_j)[None], out, 0.0)
    return out.permute(1, 0, 2).contiguous()


def synth_cuda(streams, cth, ln_sth, logc, mcut, m0: int = 0):
    """Launch K2 (16 columns, `legendre_synth`) or its 4-column form
    (`legendre_synth_phi`) on the tensors' CUDA device and PyTorch's
    current stream.  Same contract as synth_plain with its SYNTH_TILE_J
    tiles, for the rows m = m0, m0 + 1, ... (streams and logc of those
    rows); float32 only."""
    if len(streams) not in (2, 4):
        raise ValueError(f"K2 takes 4 derivative streams or 2 a-streams, "
                         f"not {len(streams)}")
    derivs = len(streams) == 4
    name = "legendre_synth" if derivs else "legendre_synth_phi"
    nm, nl = streams[0].shape
    J = cth.shape[0]
    _check_problem(name, nm, J, nl)
    keys = ("a_re", "a_im", "h_re", "h_im")[: len(streams)]
    _check_cuda_f32(
        name, dict(zip(keys, streams), cth=cth, ln_sth=ln_sth, logc=logc,
                   mcut=mcut),
        dict({k: (nm, nl) for k in keys}, cth=(J,), ln_sth=(J,), logc=(nm,),
             mcut=(-(-J // SYNTH_TILE_J),)))
    out = torch.empty((nm, 16 if derivs else 4, J), dtype=torch.float32,
                      device=cth.device)
    _ext.launch(name, f"{name}_launch", cth.device,
                *(s.data_ptr() for s in streams), cth.data_ptr(),
                ln_sth.data_ptr(), logc.data_ptr(), mcut.data_ptr(),
                out.data_ptr(), nl, nm, J, int(m0))
    return out


def synth_columns(streams, cth, ln_sth, logc, mcut, m0: int = 0):
    """K2 wrapper: the kernel for CUDA tensors, the twin for CPU tensors;
    the stream rows are m = m0, m0 + 1, ...."""
    if streams[0].device.type == "cpu":
        return synth_plain(streams, cth, ln_sth, logc, mcut,
                           m=_rows(m0, streams[0]))
    return synth_cuda(streams, cth, ln_sth, logc, mcut, m0)


def _south_sign(plan, device, m=None):
    """s_m = (-1)^m: lambda_lm(pi - theta) = (-1)^(l+m) lambda_lm(theta)."""
    return (1 - 2 * (_m_rows(m, plan.nm, device) % 2)).to(plan.dtype)[:, None]


def q_from_columns(plan, c, m=None):
    """Raw K2 columns [nm, 16, J] -> (qN, qS), each [3, nm, J] complex:
    phi, d_theta and d_theta_theta on the north / south ring of each pair;
    [nm, 4, J] -> the potential alone, each [1, nm, J].  With m (row
    indices), c holds only those rows [len(m), ncol, J].

      sum_l a lam'  = cot sum (l a) lam - (1/sin) sum h lam
      sum_l a lam'' = m^2/sin^2 sum a lam - sum l(l+1) a lam - cot sum a lam'
    and lambda_lm(pi - theta) = (-1)^(l+m) lambda_lm(theta), with the
    d_theta stream flipping sign on the south ring."""
    dt = plan.dtype
    s_m = _south_sign(plan, c.device, m)
    ns = c.shape[1] // 2

    def cplx(k):
        return torch.complex(c[:, 2 * k].to(dt), c[:, 2 * k + 1].to(dt))

    if ns == 2:
        return (cplx(0)[None].to(plan.cdtype),
                (s_m * cplx(1))[None].to(plan.cdtype))
    c0, c1, c2, c3 = cplx(0), cplx(1), cplx(2), cplx(3)
    c0a, c1a, c2a, c3a = cplx(4), cplx(5), cplx(6), cplx(7)
    cot = plan.cot[None, :]
    inv = plan.inv_sth[None, :]
    mf = plan.m_f if m is None else _m_rows(m, 0, c.device).to(dt)
    m2i2 = mf[:, None] ** 2 * inv * inv
    qthN = cot * c1 - inv * c2
    dSa = cot * c1a + inv * c2a  # sum (-1)^l a lam'
    qN = torch.stack([c0, qthN, m2i2 * c0 - c3 - cot * qthN])
    qS = torch.stack([s_m * c0a, -s_m * dSa,
                      s_m * (m2i2 * c0a - c3a - cot * dSa)])
    return qN.to(plan.cdtype), qS.to(plan.cdtype)


# ----------------------------------------------------------------------------
# K3: synthesis by l-parity buckets
# ----------------------------------------------------------------------------

def chain_seed_cuda(sth, nm: int):
    """Launch K3's seed pre-pass (`legendre_chain_seed`) on sth's CUDA
    device and PyTorch's current stream: chain_seed of every m < nm as
    ([nm, J] float32 values, [nm, J] int32 counters); float32 only."""
    name = "legendre_chain_seed"
    J = sth.shape[0]
    _check_problem(name, nm, J, 1)
    _check_cuda_f32(name, dict(sth=sth), dict(sth=(J,)))
    seed = torch.empty((nm, J), dtype=torch.float32, device=sth.device)
    seed_k = torch.empty((nm, J), dtype=torch.int32, device=sth.device)
    scratch = torch.empty(chain_seed_scratch(nm, J), dtype=torch.int32,
                          device=sth.device)
    _ext.launch(name, "legendre_chain_seed_launch", sth.device, sth.data_ptr(),
                seed.data_ptr(), seed_k.data_ptr(), scratch.data_ptr(),
                scratch.numel(), nm, J)
    return seed, seed_k


def chain_seed_scratch(nm: int, J: int) -> int:
    """int32 words of scratch K3's seed pre-pass needs: its ticket counter
    and one published-checkpoint count per 32 ring pairs, then the
    checkpoints' values and counters [ceil(nm / SEED_SEGMENT), J] each."""
    return 1 + -(-J // 32) + 2 * -(-nm // SEED_SEGMENT) * J


def synth_vpu_plain(a_re, a_im, cth, sth, cot, inv_sth, derivs: bool,
                    m=None, mcut=None, tile_j: int = SYNTH_TILE_J):
    """K3's twin.  a_re, a_im [rows, nl] (the TRANSPOSED alm of
    mx_prep(..., derivs=False)); cth, sth, cot, inv_sth [J]; mcut int32
    [ceil(J / tile_j)] or None (no cutoff).  Returns the buckets
    [rows, 2 nacc, J], nacc = 6 with derivatives (a_re, a_im) x (lambda,
    lambda', lambda'') or 2 without: column 2 s holds slot s summed over
    even l (bucket A), column 2 s + 1 over odd l (bucket B); 0 where the
    row's m is at or beyond the cutoff of the ring's tile.

    lambda' = l cot lambda - c_lm lambda_{l-1} / sin,
    lambda'' = (m^2/sin^2 - l(l+1)) lambda - cot lambda',
    c_lm = sqrt((l^2 - m^2)(2l+1)/(2l-1)), in calclens_tpu/sht/
    pallas_legendre.py's order of operations."""
    rows, nl = a_re.shape
    J = cth.shape[0]
    dt, dev = a_re.dtype, a_re.device
    m = _m_rows(m, rows, dev)
    mf = m.to(dt)
    rec = _Recurrence(cth, m, chain_seed(m, sth))
    nacc = 6 if derivs else 2
    acc = torch.zeros((2, nacc, rows, J), dtype=dt, device=dev)
    cot_r, inv_r = cot[None, :], inv_sth[None, :]
    m2i2 = (mf * mf)[:, None] * inv_r * inv_r
    for l in range(nl):
        lam = rec.step(l)
        n = rec.n
        ar, ai = a_re[:n, l, None], a_im[:n, l, None]
        b = acc[l % 2, :, :n]
        b[0].addcmul_(ar, lam)
        b[1].addcmul_(ai, lam)
        if derivs:
            lf = float(l)
            mfn = mf[:n]
            cnum = (torch.clamp((lf - mfn) * (lf + mfn), min=0.0)
                    * (2.0 * lf + 1.0))
            c = torch.sqrt(cnum / torch.full_like(cnum,
                                                  max(2.0 * lf - 1.0, 1.0)))
            lam_prev = rec.pp[:n] * rec.corfac
            lamp = (lf * cot_r) * lam - (c[:, None] * lam_prev) * inv_r
            lampp = (m2i2[:n] - lf * (lf + 1.0)) * lam - cot_r * lamp
            b[2].addcmul_(ar, lamp)
            b[3].addcmul_(ai, lamp)
            b[4].addcmul_(ar, lampp)
            b[5].addcmul_(ai, lampp)
    if mcut is not None:
        acc = torch.where(_below_cut(mcut, m, J, tile_j)[None, None], acc, 0.0)
    # [parity, slot] -> column 2 slot + parity
    return acc.permute(2, 1, 0, 3).reshape(rows, 2 * nacc, J).contiguous()


def synth_vpu_cuda(a_re, a_im, cth, sth, cot, inv_sth, derivs: bool, mcut,
                   seed=None, m0: int = 0):
    """Launch K3 (`legendre_synth_vpu` with derivatives,
    `legendre_synth_vpu_phi` without) on the tensors' CUDA device and
    PyTorch's current stream, after its seed pre-pass (chain_seed_cuda)
    unless `seed` holds that pre-pass's (values, counters) for these rings
    and rows.  Same contract as synth_vpu_plain with its SYNTH_TILE_J
    tiles, for the rows m = m0, m0 + 1, ... (the pre-pass runs for every
    m below m0 + rows, and K3 reads the rows from m0); float32 only."""
    name = "legendre_synth_vpu" if derivs else "legendre_synth_vpu_phi"
    nm, nl = a_re.shape
    J = cth.shape[0]
    _check_problem(name, nm, J, nl)
    _check_cuda_f32(
        name, dict(a_re=a_re, a_im=a_im, cth=cth, sth=sth, cot=cot,
                   inv_sth=inv_sth, mcut=mcut),
        dict(a_re=(nm, nl), a_im=(nm, nl), cth=(J,), sth=(J,), cot=(J,),
             inv_sth=(J,), mcut=(-(-J // SYNTH_TILE_J),)))
    if seed is None:
        seed, seed_k = chain_seed_cuda(sth, m0 + nm)
        seed, seed_k = seed[m0:], seed_k[m0:]
    else:
        seed, seed_k = seed
    _check_cuda_f32(name, dict(a_re=a_re, seed=seed, seed_k=seed_k),
                    dict(a_re=(nm, nl), seed=(nm, J), seed_k=(nm, J)))
    out = torch.empty((nm, 12 if derivs else 4, J), dtype=torch.float32,
                      device=a_re.device)
    _ext.launch(name, "legendre_synth_vpu_launch", a_re.device,
                a_re.data_ptr(), a_im.data_ptr(), cth.data_ptr(),
                cot.data_ptr(), inv_sth.data_ptr(), seed.data_ptr(),
                seed_k.data_ptr(), mcut.data_ptr(), out.data_ptr(), nl, nm, J,
                int(derivs), int(m0))
    return out


def synth_vpu_columns(a_re, a_im, cth, sth, cot, inv_sth, derivs: bool,
                      mcut, m0: int = 0):
    """K3 wrapper: the kernel for CUDA tensors, the twin for CPU tensors;
    the rows are m = m0, m0 + 1, ...."""
    if a_re.device.type == "cpu":
        return synth_vpu_plain(a_re, a_im, cth, sth, cot, inv_sth, derivs,
                               m=_rows(m0, a_re), mcut=mcut)
    return synth_vpu_cuda(a_re, a_im, cth, sth, cot, inv_sth, derivs, mcut,
                          m0=m0)


def q_from_buckets(plan, c, m=None):
    """K3's buckets [nm, 2 nacc, J] -> (qN, qS), each [nacc / 2, nm, J]
    complex: qN = A + B, qS = s_m (A - B), with the d_theta kernel's sign
    flipped on the south ring (calclens_tpu/sht/pallas_legendre.py::
    synthesis_pallas).  With m, c holds only those rows."""
    dt = plan.dtype
    s_m = _south_sign(plan, c.device, m)
    qN, qS = [], []
    for k in range(c.shape[1] // 4):
        Are, Bre, Aim, Bim = (c[:, 4 * k + i].to(dt) for i in range(4))
        qn = torch.complex(Are + Bre, Aim + Bim)
        qs = s_m * torch.complex(Are - Bre, Aim - Bim)
        qN.append(qn)
        qS.append(-qs if k == 1 else qs)
    return (torch.stack(qN).to(plan.cdtype), torch.stack(qS).to(plan.cdtype))
