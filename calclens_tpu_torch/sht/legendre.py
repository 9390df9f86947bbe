"""The two Legendre sweeps of the SHT: CUDA kernel wrappers and plain twins.

K1, the analysis alm[l, m] = sum_j lambda_lm(theta_j) S_{l mod 2}[m, j]
(csrc/legendre_analysis.cu; replaces calclens_tpu/sht/pallas_legendre.py::
_analysis_kernel), and K2, the synthesis's 16 raw columns
sum_l lambda_lm(theta_j) s(l, m) (csrc/legendre_synth.cu; replaces
calclens_tpu/sht/pallas_legendre_mx.py::_synth_mx_kernel).

Each kernel has a plain PyTorch twin here: a Python loop over l on [nm, J]
tensors that computes the kernel's own math (the log2-space diagonal seed,
the 2^64 scale counter, the per-j-tile turning-point cutoff of the analysis)
with the same float32 roundings, op for op, as the kernels' recurrence
(csrc/legendre_common.cuh): near the poles the recurrence amplifies a
rounding difference by up to ~1/sin(theta), so only an evaluation that
rounds alike can be held to float32 accuracy.
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

# rings per analysis block: the kernel's tile, and the unit of its m cutoff
ANALYSIS_TILE_J = 512


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


def _seed(logc, mf, ln_sth):
    """Direct diagonal seed lambda_mm = stored * 2^(64 k), stored in
    [2^-32, 2^32): [nm, J] values and int32 scale counters.  A ceil-based
    window would give k = +1 where lambda_mm > 1 (near the equator at large
    m) and the scale cutoff would then drop legitimate values."""
    log2lam = (logc[:, None] + mf[:, None] * ln_sth[None, :]
               - _HALF_LN_4PI) * _LOG2E
    kf = torch.floor((log2lam + 32.0) * (1.0 / 64.0))
    return torch.exp2(log2lam - 64.0 * kf), kf.to(torch.int32)


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
    """State of the scaled lambda recurrence over all (m, j): step(l)
    returns lambda_lm(theta_j) [nm, J] (exactly 0 for m > l and below
    2^-64 of the stored scale)."""

    def __init__(self, cth, ln_sth, logc, mf):
        self.cth = cth[None, :]
        self.mf = mf
        self.m = torch.arange(len(mf), device=mf.device)[:, None]
        self.seedval, self.seedk = _seed(logc, mf, ln_sth)
        shape = self.seedval.shape
        self.pp = torch.zeros(shape, dtype=cth.dtype, device=cth.device)
        self.pc = torch.zeros_like(self.pp)
        self.k = torch.zeros(shape, dtype=torch.int32, device=cth.device)

    def step(self, l: int):
        a, b = _coeffs(l, self.mf)
        new = a[:, None] * (self.cth * self.pc - b[:, None] * self.pp)
        seed_row = self.m == l
        inactive = self.m > l
        new = torch.where(seed_row, self.seedval,
                          torch.where(inactive, 0.0, new))
        prev = torch.where(seed_row | inactive, 0.0, self.pc)
        k = torch.where(seed_row, self.seedk, self.k)
        big = new.abs() > _TH_BIG
        new = torch.where(big, new * _RESC, new)
        prev = torch.where(big, prev * _RESC, prev)
        k = k + big.to(torch.int32)
        self.pp, self.pc, self.k = prev, new, k
        corfac = torch.where(k == 0, 1.0, torch.where(k == -1, _RESC, 0.0))
        return new * corfac.to(new.dtype)


def _check_cuda_f32(name, tensors, shapes):
    for key, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {x.device}, not on CUDA")
        want = torch.int32 if key == "mcut" else torch.float32
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


# ----------------------------------------------------------------------------
# K1: analysis
# ----------------------------------------------------------------------------

def analysis_mcut(sth_host, nl: int, nm: int):
    """Per-j-tile turning-point cutoff (int32 [ceil(J / 512)]): m >= mcut
    contributes nothing to the tile's rings (transforms.m_cutoff at
    granularity 1 on the tile's largest sin theta)."""
    from .transforms import m_cutoff

    sth = np.asarray(sth_host, np.float64)
    T = ANALYSIS_TILE_J
    return np.array([m_cutoff(nl - 1, float(np.max(sth[t: t + T])), nm,
                              granularity=1) for t in range(0, len(sth), T)],
                    dtype=np.int32)


def analysis_plain(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl: int,
                   tile_j: int = ANALYSIS_TILE_J):
    """K1's twin.  E/O planes [nm, J]; cth, ln_sth [J]; logc [nm]; mcut
    int32 [ceil(J / tile_j)].  Returns (alm_re, alm_im), each TRANSPOSED
    [nm, nl] like the kernel's output."""
    nm, J = ere.shape
    dt, dev = ere.dtype, ere.device
    mf = torch.arange(nm, dtype=dt, device=dev)
    # turning-point cutoff: zero the sources of every (m, j) the kernel skips
    tile_cut = torch.as_tensor(mcut, device=dev).long()
    jcut = tile_cut.repeat_interleave(tile_j)[:J]
    keep = (torch.arange(nm, device=dev)[:, None] < jcut[None, :]).to(dt)
    m_even = (torch.arange(nm, device=dev) % 2 == 0)[:, None]
    s0r = torch.where(m_even, ere, ore) * keep
    s0i = torch.where(m_even, eim, oim) * keep
    s1r = torch.where(m_even, ore, ere) * keep
    s1i = torch.where(m_even, oim, eim) * keep
    rec = _Recurrence(cth, ln_sth, logc, mf)
    out_re = torch.zeros((nl, nm), dtype=dt, device=dev)
    out_im = torch.zeros_like(out_re)
    for l in range(nl):
        lam = rec.step(l)
        sr, si = (s1r, s1i) if l % 2 else (s0r, s0i)
        out_re[l] = (lam * sr).sum(dim=1)
        out_im[l] = (lam * si).sum(dim=1)
    return out_re.T.contiguous(), out_im.T.contiguous()


def analysis_cuda(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl: int):
    """Launch K1 on the tensors' CUDA device and PyTorch's current stream.
    Same contract as analysis_plain; float32 only."""
    nm, J = ere.shape
    if nm == 0 or J == 0 or nl == 0:
        raise ValueError(f"legendre_analysis: empty problem nm={nm} J={J} "
                         f"nl={nl}")
    if nm > 65535:
        raise ValueError(f"legendre_analysis: nm={nm} exceeds the grid's "
                         "y dimension")
    nt = -(-J // ANALYSIS_TILE_J)
    _check_cuda_f32(
        "legendre_analysis",
        dict(ere=ere, eim=eim, ore=ore, oim=oim, cth=cth, ln_sth=ln_sth,
             logc=logc, mcut=mcut),
        dict(ere=(nm, J), eim=(nm, J), ore=(nm, J), oim=(nm, J), cth=(J,),
             ln_sth=(J,), logc=(nm,), mcut=(nt,)))
    alm_re = torch.zeros((nm, nl), dtype=torch.float32, device=ere.device)
    alm_im = torch.zeros_like(alm_re)
    lib = _ext.lib()
    with torch.cuda.device(ere.device):
        stream = torch.cuda.current_stream(ere.device).cuda_stream
        code = lib.legendre_analysis_launch(
            ere.data_ptr(), eim.data_ptr(), ore.data_ptr(), oim.data_ptr(),
            cth.data_ptr(), ln_sth.data_ptr(), logc.data_ptr(),
            mcut.data_ptr(), alm_re.data_ptr(), alm_im.data_ptr(),
            nl, nm, J, stream)
    _ext.check(code, "legendre_analysis")
    _ext.launches["legendre_analysis"] += 1
    return alm_re, alm_im


def analysis_columns(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl: int):
    """K1 wrapper: the kernel for CUDA tensors, the twin for CPU tensors."""
    if ere.device.type == "cpu":
        return analysis_plain(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl)
    return analysis_cuda(ere, eim, ore, oim, cth, ln_sth, logc, mcut, nl)


def analysis_inputs(plan, E, O):
    """Kernel-ready K1 inputs from the folded ring-pair sums E, O [nm, J]
    (complex): contiguous real/imaginary planes, geometry rows, the seed
    table and the per-tile cutoff.  No padding: the kernel masks the ragged
    j edge itself."""
    rdt = plan.dtype
    planes = [x.contiguous() for x in (E.real.to(rdt), E.imag.to(rdt),
                                       O.real.to(rdt), O.imag.to(rdt))]
    mcut = torch.as_tensor(analysis_mcut(plan.sth_host, plan.nl, plan.nm),
                           device=E.device)
    return (*planes, plan.cth, plan.ln_sth, plan.logc, mcut)


# ----------------------------------------------------------------------------
# K2: synthesis with derivatives
# ----------------------------------------------------------------------------

def _dfac_rows(nl: int, nm: int, dtype, device):
    """d_lm = sqrt((l^2 - m^2)(2l+1)/(2l-1)) for l = 1..nl (the d_theta
    lowering factor) [nl, nm]."""
    l = torch.arange(1, nl + 1, dtype=dtype, device=device)[:, None]
    m = torch.arange(nm, dtype=dtype, device=device)[None, :]
    num = torch.clamp(l * l - m * m, min=0.0) * (2.0 * l + 1.0)
    den = torch.clamp(2.0 * l - 1.0, min=1.0)
    return torch.sqrt(num / den)


def mx_prep(nl: int, nm: int, alm, dtype):
    """alm [nl, nm] complex -> the four TRANSPOSED stream planes [nm, nl]
    (a_re, a_im, h_re, h_im) with h_l = d_{l+1} a_{l+1} (summation by parts
    of the d_theta lowering recurrence)."""
    ar = alm.real.to(dtype)
    ai = alm.imag.to(dtype)
    d = _dfac_rows(nl - 1, nm, dtype, alm.device)  # rows l = 1..nl-1
    zero = torch.zeros((1, nm), dtype=dtype, device=alm.device)
    hr = torch.cat([ar[1:] * d, zero])
    hi = torch.cat([ai[1:] * d, zero])
    return tuple(x.T.contiguous() for x in (ar, ai, hr, hi))


def synth_plain(a_re, a_im, h_re, h_im, cth, ln_sth, logc):
    """K2's twin.  Streams [nm, nl]; cth, ln_sth [J]; logc [nm].  Returns
    the raw columns [nm, 16, J]: {a, l a, h, l(l+1) a} x {re, im} summed
    with weight 1 (columns 0-7) and (-1)^l (columns 8-15)."""
    nm, nl = a_re.shape
    J = cth.shape[0]
    dt, dev = a_re.dtype, a_re.device
    mf = torch.arange(nm, dtype=dt, device=dev)
    rec = _Recurrence(cth, ln_sth, logc, mf)
    # even- and odd-l sums of the 8 streams
    acc = torch.zeros((2, 8, nm, J), dtype=dt, device=dev)
    for l in range(nl):
        lam = rec.step(l)
        lf = float(l)
        ar, ai = a_re[:, l], a_im[:, l]
        s8 = torch.stack([ar, ai, ar * lf, ai * lf, h_re[:, l], h_im[:, l],
                          ar * (lf * (lf + 1.0)), ai * (lf * (lf + 1.0))])
        acc[l % 2].addcmul_(s8[:, :, None], lam[None])  # in place: no temp
    out = torch.cat([acc[0] + acc[1], acc[0] - acc[1]])  # [16, nm, J]
    return out.permute(1, 0, 2).contiguous()


def synth_cuda(a_re, a_im, h_re, h_im, cth, ln_sth, logc):
    """Launch K2 on the tensors' CUDA device and PyTorch's current stream.
    Same contract as synth_plain; float32 only."""
    nm, nl = a_re.shape
    J = cth.shape[0]
    if nm == 0 or J == 0 or nl == 0:
        raise ValueError(f"legendre_synth: empty problem nm={nm} J={J} "
                         f"nl={nl}")
    if nm > 65535:
        raise ValueError(f"legendre_synth: nm={nm} exceeds the grid's y "
                         "dimension")
    _check_cuda_f32(
        "legendre_synth",
        dict(a_re=a_re, a_im=a_im, h_re=h_re, h_im=h_im, cth=cth,
             ln_sth=ln_sth, logc=logc),
        dict(a_re=(nm, nl), a_im=(nm, nl), h_re=(nm, nl), h_im=(nm, nl),
             cth=(J,), ln_sth=(J,), logc=(nm,)))
    out = torch.empty((nm, 16, J), dtype=torch.float32, device=a_re.device)
    lib = _ext.lib()
    with torch.cuda.device(a_re.device):
        stream = torch.cuda.current_stream(a_re.device).cuda_stream
        code = lib.legendre_synth_launch(
            a_re.data_ptr(), a_im.data_ptr(), h_re.data_ptr(),
            h_im.data_ptr(), cth.data_ptr(), ln_sth.data_ptr(),
            logc.data_ptr(), out.data_ptr(), nl, nm, J, stream)
    _ext.check(code, "legendre_synth")
    _ext.launches["legendre_synth"] += 1
    return out


def synth_columns(a_re, a_im, h_re, h_im, cth, ln_sth, logc):
    """K2 wrapper: the kernel for CUDA tensors, the twin for CPU tensors."""
    if a_re.device.type == "cpu":
        return synth_plain(a_re, a_im, h_re, h_im, cth, ln_sth, logc)
    return synth_cuda(a_re, a_im, h_re, h_im, cth, ln_sth, logc)


def q_from_columns(plan, c):
    """Raw columns [nm, 16, J] -> (qN, qS), each [3, nm, J] complex: phi,
    d_theta and d_theta_theta on the north / south ring of each pair.

      sum_l a lam'  = cot sum (l a) lam - (1/sin) sum h lam
      sum_l a lam'' = m^2/sin^2 sum a lam - sum l(l+1) a lam - cot sum a lam'
    and lambda_lm(pi - theta) = (-1)^(l+m) lambda_lm(theta), with the
    d_theta stream flipping sign on the south ring."""
    dt = plan.dtype
    s_m = (1 - 2 * (torch.arange(plan.nm, device=c.device) % 2)).to(dt)[:, None]

    def cplx(k):
        return torch.complex(c[:, 2 * k].to(dt), c[:, 2 * k + 1].to(dt))

    c0, c1, c2, c3 = cplx(0), cplx(1), cplx(2), cplx(3)
    c0a, c1a, c2a, c3a = cplx(4), cplx(5), cplx(6), cplx(7)
    cot = plan.cot[None, :]
    inv = plan.inv_sth[None, :]
    m2i2 = plan.m_f[:, None] ** 2 * inv * inv
    qthN = cot * c1 - inv * c2
    dSa = cot * c1a + inv * c2a  # sum (-1)^l a lam'
    qN = torch.stack([c0, qthN, m2i2 * c0 - c3 - cot * qthN])
    qS = torch.stack([s_m * c0a, -s_m * dSa,
                      s_m * (m2i2 * c0a - c3a - cot * dSa)])
    return qN.to(plan.cdtype), qS.to(plan.cdtype)
