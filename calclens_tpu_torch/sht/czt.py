"""Batched chirp-Z transform on torch.fft: exact per-ring DFTs, one shape.

Port of calclens_tpu/sht/czt.py.  HEALPix rings have 4, 8, ..., 4*nside
pixels; every ring's length-n DFT is evaluated by the Bluestein / chirp-Z
factorization at one padded FFT length L:

    X_k = w_k * IFFT_L( FFT_L(x_j * w_j) * FFT_L(v) )_k,
    w_t = exp(s*i*pi*t^2/n),  v_t = conj(w_t),  s = -1 analysis / +1 synthesis

Chirp phases use the exact integer reduction t^2 mod 2n, so the phase error
stays at float rounding level even for t^2 ~ 2^30 (nside <= 8192).

The tables (w and FFT_L(v)) depend only on the ring lengths and the shapes,
never on the data: TableCache builds them once per key, for the distinct
ring lengths only (a HEALPix map has about nside + 1 of them against 4 nside
rings), and czt_blocked gathers each block's rows from them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.profile import count


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


class TableCache:
    """Tables that depend on the geometry alone (chirp tables, phase tables,
    gather indices), each built once per key on first use and kept, unless
    it is larger than max_bytes (None: no limit): such a table is built
    anew at every call.  `builds` counts the tables built; nbytes(kind)
    sums the bytes of the tables whose key starts with `kind` (all of them
    when None)."""

    def __init__(self, device, max_bytes=None):
        self.device = torch.device(device)
        self.max_bytes = max_bytes
        self._tables = {}
        self.builds = 0

    def keeps(self, nbytes):
        """Whether a table of nbytes would be kept."""
        return self.max_bytes is None or nbytes <= self.max_bytes

    def get(self, key, build):
        """The table under `key`, from build() the first time (every time
        when it is too large to keep)."""
        hit = self._tables.get(key)
        if hit is None:
            hit = build()
            self.builds += 1
            if self.keeps(_size(hit)):
                self._tables[key] = hit
        return hit

    def chirp(self, name, n, N, K, L, sign, cdtype, Nk=None):
        """czt tables of the rings `name` names, of lengths n (host [R]),
        for their distinct lengths only: (w [D, tmax], Vf [D, L], rows
        [R]), row r's tables being row rows[r] of w and Vf.  The key is
        the name and the shapes: n is read only when the tables are
        built."""
        def build():
            uniq, inv = np.unique(np.asarray(n, dtype=np.int64),
                                  return_inverse=True)
            count("host_sync", 2)    # the two host -> device copies
            w, Vf = czt_tables(torch.as_tensor(uniq, device=self.device),
                               N, K, L, sign, cdtype, Nk=Nk)
            return w, Vf, torch.as_tensor(inv.reshape(-1), device=self.device)

        return self.get(("czt", name, int(N), int(K), int(L), int(sign), Nk,
                         cdtype), build)

    def nbytes(self, kind=None):
        return sum(_size(t) for k, t in self._tables.items()
                   if kind is None or k[0] == kind)


def _size(t):
    """Bytes of a table: a tensor, a tuple of them, or a host array (ints
    count 0)."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, tuple):
        return sum(_size(x) for x in t)
    return getattr(t, "nbytes", 0)


def czt(x, K, tables):
    """Chirp-Z transform of each row of x.

    x : [..., R, N] rows (complex or real); entries at j >= Nk must be 0.
        Leading axes are streams sharing the same rings (and tables).
    K : output frequencies per row.
    tables : (w [R, >= max(N, K)], Vf [R, L]) of these rows, as czt_tables
        gives them (their sign, Nk and dtype are the transform's).
    Returns [..., R, K] complex.
    """
    N = x.shape[-1]
    w, Vf = tables
    a = torch.zeros(x.shape[:-1] + Vf.shape[-1:], dtype=Vf.dtype,
                    device=x.device)
    a[..., :N] = x.to(Vf.dtype) * w[..., :N]
    X = torch.fft.ifft(torch.fft.fft(a, dim=-1) * Vf, dim=-1)
    return X[..., :K] * w[..., :K]


def czt_blocked(x, n, K, L, sign, cdtype, block, cache, name, real=False,
                Nk=None):
    """czt of x [..., R, N] over rings n [R] (host) in row blocks of
    `block` rings, to bound peak memory (leading stream axes ride along
    whole).  The tables come from `cache` (a TableCache) under `name`:
    each block gathers its rows' w and Vf.  real=True keeps only the real
    part of each block's output, so the full complex result never
    exists."""
    R = x.shape[-2]
    if R % block:
        raise ValueError(f"{R} rows are not a multiple of block {block}")
    w, Vf, rows = cache.chirp(name, n, x.shape[-1], K, L, sign, cdtype, Nk=Nk)
    outs = []
    for i in range(0, R, block):
        r = rows[i: i + block]
        X = czt(x[..., i: i + block, :], K, (w[r], Vf[r]))
        outs.append(X.real.contiguous() if real else X)
    return torch.cat(outs, dim=-2) if len(outs) > 1 else outs[0]
