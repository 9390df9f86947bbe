"""Batched chirp-Z transform on torch.fft: exact per-ring DFTs, one shape.

Port of calclens_tpu/sht/czt.py.  HEALPix rings have 4, 8, ..., 4*nside
pixels; every ring's length-n DFT is evaluated by the Bluestein / chirp-Z
factorization at one padded FFT length L:

    X_k = w_k * IFFT_L( FFT_L(x_j * w_j) * FFT_L(v) )_k,
    w_t = exp(s*i*pi*t^2/n),  v_t = conj(w_t),  s = -1 analysis / +1 synthesis

Chirp phases use the exact integer reduction t^2 mod 2n, so the phase error
stays at float rounding level even for t^2 ~ 2^30 (nside <= 8192).
"""

from __future__ import annotations

import math

import torch


def _chirp(tmax, n, sign, cdtype):
    """w_t = exp(sign * i*pi*t^2/n) for t = 0..tmax-1, per row n [R]."""
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    t = torch.arange(tmax, dtype=torch.int64, device=n.device)[None, :]
    n = n[:, None].long()
    t2 = (t * t) % (2 * n)
    ph = (math.pi * sign) * (t2.to(rdtype) / n.to(rdtype))
    return torch.complex(torch.cos(ph), torch.sin(ph))


def czt_tables(n, N, K, L, sign, cdtype, Nk=None):
    """Data-independent chirp tables for rings n [R]: (w [R, tmax], Vf [R, L]).

    Nk: max input position with nonzero content + 1 (default N); the
    convolution reads lags k - j for outputs k < K and inputs j < Nk, so the
    kernel needs positions [0, K) and [L - Nk + 1, L) only."""
    R = n.shape[0]
    Nk = N if Nk is None else Nk
    tmax = max(N, K)
    if L < Nk + K - 1:
        raise ValueError(f"chirp-Z length L={L} < Nk + K - 1 = {Nk + K - 1}")
    w = _chirp(tmax, n, +sign, cdtype)
    v = _chirp(tmax, n, -sign, cdtype)
    vc = torch.zeros((R, L), dtype=cdtype, device=n.device)
    vc[:, :K] = v[:, :K]
    if Nk > 1:
        vc[:, L - Nk + 1:] += v[:, 1: Nk].flip(-1)
    return w, torch.fft.fft(vc, dim=1)


def czt(x, n, K, L, sign, cdtype, Nk=None):
    """Chirp-Z transform of each row of x.

    x : [..., R, N] rows (complex or real); entries at j >= Nk must be 0.
        Leading axes are streams sharing the same rings (and tables).
    n : [R] per-row DFT length.   K : output frequencies per row.
    sign : +1 evaluates sum_j x_j e^{+2i pi jk/n}, -1 the forward DFT.
    Nk : see czt_tables.
    Returns [..., R, K] complex.
    """
    N = x.shape[-1]
    w, Vf = czt_tables(n, N, K, L, sign, cdtype, Nk=Nk)
    a = torch.zeros(x.shape[:-1] + (L,), dtype=cdtype, device=x.device)
    a[..., :N] = x.to(cdtype) * w[..., :N]
    X = torch.fft.ifft(torch.fft.fft(a, dim=-1) * Vf, dim=-1)
    return X[..., :K] * w[..., :K]


def czt_blocked(x, n, K, L, sign, cdtype, block, real=False):
    """Apply czt in row blocks of `block` rings to bound peak memory
    (leading stream axes ride along whole).  real=True keeps only the real
    part of each block's output, so the full complex result never exists."""
    R = x.shape[-2]
    if R % block:
        raise ValueError(f"{R} rows are not a multiple of block {block}")
    outs = []
    for i in range(0, R, block):
        X = czt(x[..., i: i + block, :], n[i: i + block], K, L, sign, cdtype)
        outs.append(X.real.contiguous() if real else X)
    return torch.cat(outs, dim=-2) if len(outs) > 1 else outs[0]
