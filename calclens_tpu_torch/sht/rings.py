"""Ring-space DFT stage of the analysis: RING map -> G_m per ring.

Port of the analysis half of calclens_tpu/sht/rings.py::RingStage.  HEALPix
ring lengths are 4i (polar caps, i < nside) and 4*nside (the equatorial
belt):

  * belt: one batched real FFT of length P = 4*nside over a contiguous pixel
    slice; modes m > P/2 come from Hermitian symmetry;
  * caps: rings grouped by the padded FFT length needed to emit their first
    K = m_cutoff(lmax, sin theta) frequencies; each group runs one chirp-Z
    (czt.py).  Columns beyond a group's turning-point cutoff face an
    underflowed lambda in the Legendre stage and are zero-filled.  Each cap
    row is fetched with an aligned block gather (whole B-pixel blocks of the
    map); the row content then sits at offset d_r = startpix_r mod B, an
    exact per-ring phase folded into the phi0 phase table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from calclens_tpu.healpix import core as hp

from .czt import czt


def _pad_rows(n, mult=8):
    return ((n + mult - 1) // mult) * mult


def _next_fft_len(n: int) -> int:
    """Smallest 2^k or 3*2^k >= n."""
    p2 = 1 << (int(n) - 1).bit_length()
    p3 = 3 * (1 << max((int(n) - 1) // 3, 1).bit_length())
    while p3 < n:
        p3 *= 2
    return min(p2, p3)


class RingStage:
    """Host-built (small) tables + device method for map -> ring modes.

    G layout: [nrings_pad, nm] complex, ring r at row r.
    """

    def __init__(self, order, nm, nrings_pad, device, dtype=torch.float32):
        from .transforms import m_cutoff

        self.order = order
        self.nside = nside = 1 << order
        self.P = P = 4 * nside
        self.nm = nm
        self.nrings = 4 * nside - 1
        self.nrings_pad = nrings_pad
        self.device = torch.device(device)
        self.dtype = dtype
        self.cdtype = (torch.complex64 if dtype == torch.float32
                       else torch.complex128)
        self.npix = int(hp.order2npix(order))

        rt = hp.build_ring_table(order)
        self.startpix = rt.startpix.astype(np.int64)
        self.ringpix = rt.ringpix.astype(np.int64)
        self.shifted = rt.shifted.copy()

        rings = np.arange(self.nrings)
        eq = self.ringpix == P
        self.eq_rows = rings[eq]
        cap_rows = rings[~eq]

        # per-ring sin(theta) (closed form) for the turning-point cutoff
        r1 = rings + 1
        z = np.where(
            r1 < nside, 1.0 - r1**2 / (3.0 * nside**2),
            np.where(r1 > 3 * nside,
                     (4 * nside - r1) ** 2 / (3.0 * nside**2) - 1.0,
                     4.0 / 3.0 - 2.0 * r1 / (3.0 * nside)))
        self.sth_allrings = np.sqrt(np.maximum(1.0 - z * z, 0.0))

        self.B = B = min(128, 1 << (2 * order + 2))
        assert self.npix % B == 0
        self.abuckets = []
        if len(cap_rows):
            Kr = np.array([m_cutoff(nm - 1, self.sth_allrings[r], nm,
                                    granularity=256) for r in cap_rows])
            # +B: the block-gathered content of a row ends at d + n < n + B
            Lkey = np.array([_next_fft_len(int(n) + B + int(K) - 1)
                             for n, K in zip(self.ringpix[cap_rows], Kr)])
            for L in np.unique(Lkey):
                sel = cap_rows[Lkey == L]
                nr = len(sel)
                rows_pad = _pad_rows(nr)
                nmax = int(self.ringpix[sel].max())
                nvec = np.full(rows_pad, nmax, dtype=np.int64)
                nvec[:nr] = self.ringpix[sel]
                b = dict(rows=sel, rows_pad=rows_pad, nmax=nmax,
                         K=int(Kr[Lkey == L].max()), Nk=nmax + B)
                nbl = (nmax - 1) // B + 2
                b["nbl"] = nbl
                # the padded block width can exceed the content-based L at
                # tiny orders (B dominates n + K)
                b["L"] = max(int(L), _next_fft_len(nbl * B))
                assert b["L"] >= b["Nk"] + b["K"] - 1, b
                bstart = np.zeros(rows_pad, np.int64)
                bstart[:nr] = self.startpix[sel] // B
                bidx = np.minimum(bstart[:, None] + np.arange(nbl)[None, :],
                                  self.npix // B - 1)
                d = np.zeros(rows_pad, np.int64)
                d[:nr] = self.startpix[sel] % B
                b["d_host"] = d
                b["bidx"] = torch.as_tensor(bidx.reshape(-1), device=self.device)
                b["d"] = torch.as_tensor(d, device=self.device)
                b["n"] = torch.as_tensor(nvec, device=self.device)
                self.abuckets.append(b)

        # analysis phase shift: phi0 shift MINUS the block-gather offset
        # (2 d_r in half-pixel units of pi / n_r), exact integers
        ash = np.zeros(nrings_pad, dtype=np.int64)
        ash[: self.nrings] = self.shifted.astype(np.int64)
        for b in self.abuckets:
            rows = b["rows"]
            ash[rows] -= 2 * b["d_host"][: len(rows)]
        npad = np.full(nrings_pad, P, dtype=np.int64)
        npad[: self.nrings] = self.ringpix
        self.ashift = torch.as_tensor(ash, device=self.device)
        self.n_allrows = torch.as_tensor(npad, device=self.device)

    def _phase_analysis(self):
        """e^{-i pi m (shift - 2 d)/n} [nrings_pad, nm]; the integer product
        is reduced mod 2n before the float conversion."""
        m = torch.arange(self.nm, dtype=torch.int64, device=self.device)
        n = self.n_allrows[:, None]
        t = (m[None, :] * self.ashift[:, None]) % (2 * n)
        ang = (-math.pi) * (t.to(self.dtype) / n.to(self.dtype))
        return torch.complex(torch.cos(ang), torch.sin(ang))

    def _gather_rows_blocked(self, maps, b):
        """Aligned block-row gather for bucket b: [..., rows_pad, nbl*B] with
        row r's ring pixels at columns [d_r, d_r + n_r), zeros elsewhere."""
        B = self.B
        mr = maps.reshape(maps.shape[:-1] + (self.npix // B, B))
        X = mr[..., b["bidx"], :]
        X = X.reshape(maps.shape[:-1] + (b["rows_pad"], b["nbl"] * B))
        j = torch.arange(b["nbl"] * B, device=self.device)[None, :]
        d = b["d"][:, None]
        return torch.where((j >= d) & (j < d + b["n"][:, None]), X, 0.0)

    def analysis(self, maps):
        """RING map(s) [..., npix] -> G [..., nrings_pad, nm] complex,

        G[r, m] = e^{-i m phi0_r} * DFT_{n_r}(x_r)[m mod n_r],

        assembled by concatenating contiguous ring ranges in ring order."""
        nm, P = self.nm, self.P
        lead = maps.shape[:-1]
        nlead = int(np.prod(lead)) if lead else 1

        # belt: contiguous pixel slice, batched rfft, Hermitian unfold
        ne = len(self.eq_rows)
        p0 = int(self.startpix[self.eq_rows[0]])
        Xe = maps[..., p0: p0 + ne * P].reshape(lead + (ne, P))
        Fh = torch.fft.rfft(Xe, dim=-1)  # [..., ne, P/2+1]
        H = P // 2 + 1
        if nm <= H:
            Ge = Fh[..., :nm]
        else:
            # m in [H, nm) aliases to conj(Fh[P - m]): a reversed contiguous
            # column range
            assert nm <= P, (nm, P)
            folded = torch.conj(Fh[..., P - nm + 1: P - H + 1].flip(-1))
            Ge = torch.cat([Fh, folded], dim=-1)
        Ge = Ge.to(self.cdtype)

        # cap buckets: one chirp-Z per group emitting the first K frequencies
        # directly (the chirp DFT is n-periodic in m by construction)
        pieces = [(int(self.eq_rows[0]), Ge)]
        for b in self.abuckets:
            Xb = self._gather_rows_blocked(maps, b)
            Xf = Xb.reshape((nlead * b["rows_pad"], b["nbl"] * self.B))
            nrow = b["n"].repeat(nlead)
            K = b["K"]
            Gb = czt(Xf, nrow, K=K, L=b["L"], sign=-1, cdtype=self.cdtype,
                     Nk=b["Nk"])
            Gb = Gb.reshape(lead + (b["rows_pad"], K))
            if K < nm:
                Gb = torch.nn.functional.pad(Gb, (0, nm - K))
            # bucket rows = [north range..., south range..., padding]
            rows = b["rows"]
            nn = int(np.sum(rows < self.eq_rows[0]))
            assert np.all(np.diff(rows) > 0)
            if nn:
                pieces.append((int(rows[0]), Gb[..., :nn, :]))
            if nn < len(rows):
                pieces.append((int(rows[nn]), Gb[..., nn: len(rows), :]))
        pieces.sort(key=lambda t: t[0])
        nxt = 0
        for r0, piece in pieces:  # the pieces tile rings 0..nrings-1 exactly
            assert r0 == nxt, (r0, nxt)
            nxt += piece.shape[-2]
        assert nxt == self.nrings, (nxt, self.nrings)
        pad = torch.zeros(lead + (self.nrings_pad - self.nrings, nm),
                          dtype=self.cdtype, device=self.device)
        out = torch.cat([p for _, p in pieces] + [pad], dim=-2)
        return out * self._phase_analysis()
