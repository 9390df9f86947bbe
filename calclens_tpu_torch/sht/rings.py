"""Ring-space DFT stages: RING map <-> per-ring modes, belt FFT + cap chirp-Z.

Port of calclens_tpu/sht/rings.py::RingStage.  HEALPix ring lengths are 4i
(polar caps, i < nside) and 4*nside (the equatorial belt):

  * belt: one batched real FFT of length P = 4*nside over a contiguous pixel
    slice (analysis), or one irfft of the Hermitian half-spectrum
    (synthesis); modes m > P/2 alias onto P - m;
  * caps, analysis: rings grouped by the padded FFT length needed to emit
    their first K = m_cutoff(lmax, sin theta) frequencies; each group runs
    one chirp-Z (czt.py).  Columns beyond a group's turning-point cutoff
    face an underflowed lambda in the Legendre stage and are zero-filled.
    Each cap row is fetched with an aligned block gather (whole B-pixel
    blocks of the map); the row content then sits at offset d_r =
    startpix_r mod B, an exact per-ring phase folded into the phase table;
  * caps, synthesis (`synthesis`, v2): rings bucketed by length octave; a
    ring of length n only needs its own n DFT values, since the synthesis
    sum is n-periodic in m, so q_m is folded into m mod n bins first and
    each bucket runs one chirp-Z with K = n_max, L = 2 n_max.

Every table that depends on the geometry alone (chirp tables, the phase
tables and analysis gather masks, the fold and assembly gather indices) is
built on the device at its first use and kept in the TableCache, so later
calls rebuild none of them.  The synthesis stages take Y = Q times
SHTPlan.synthesis_phase(), whose integer m * shift product is reduced mod
2n first (the JAX RingStage forms m * shift / n in floating point, ~1e-3
rad off in float32 at m ~ 10^4 on 4-pixel rings).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..healpix import core as hp
from .czt import czt_blocked
from .plan import pix2ring_index, times_phase


def _pad_rows(n, mult=8):
    return ((n + mult - 1) // mult) * mult


def _next_fft_len(n: int) -> int:
    """Smallest 2^k or 3*2^k >= n."""
    p2 = 1 << (int(n) - 1).bit_length()
    p3 = 3 * (1 << max((int(n) - 1) // 3, 1).bit_length())
    while p3 < n:
        p3 *= 2
    return min(p2, p3)


def _block(rows, L):
    """Rows per chirp-Z block: a divisor of `rows` that bounds the [block,
    L] work arrays as SHTPlan.ring_block does for the uniform stage."""
    return math.gcd(rows, max(8, min(4096, (1 << 26) // L)))


def belt_rows(Ye, P, cdtype):
    """Belt rows Ye [..., rows, nm] (ring length P each) -> their pixels
    [..., rows * P] real: the Hermitian half-spectrum half[k] = c_k Y_k +
    Y_{P-k}^* / 2 (c_k 1 at k = 0 and P/2, 1/2 between; the second term
    where P - k < nm and 0 < k < P/2), then one irfft.  Modes m > P/2
    alias: Re[Y_m e^{2 pi i m p/P}] = Re[Y_m^* e^{2 pi i (P-m) p/P}].  The
    imaginary parts at k = 0 and P/2, which a real transform drops, are
    zeroed here rather than left to the FFT library."""
    nm = Ye.shape[-1]
    H = P // 2 + 1
    half = torch.zeros(Ye.shape[:-1] + (H,), dtype=cdtype, device=Ye.device)
    nd = min(nm, H)
    half[..., :nd] = 0.5 * Ye[..., :nd]
    half[..., 0] = Ye[..., 0]
    if nm > P // 2:
        half[..., P // 2] = Ye[..., P // 2]
    if nm > H:
        half[..., P - nm + 1: P // 2] += 0.5 * torch.conj(
            Ye[..., H: nm].flip(-1))
    im = half.imag
    im[..., 0] = 0.0
    im[..., P // 2] = 0.0
    Xe = torch.fft.irfft(half, n=P, dim=-1, norm="forward")
    return Xe.reshape(Xe.shape[:-2] + (-1,))


class RingStage:
    """Host-built (small) tables + device methods for map <-> ring modes.

    G and Y layout: [..., nrings_pad, nm] complex, ring r at row r.
    """

    def __init__(self, order, nm, nrings_pad, device, tables,
                 dtype=torch.float32, min_bucket_n=64):
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
        self.tables = tables  # a TableCache

        rt = hp.build_ring_table(order)
        self.startpix = rt.startpix.astype(np.int64)
        self.ringpix = rt.ringpix.astype(np.int64)
        self.shifted = rt.shifted.copy()

        rings = np.arange(self.nrings)
        eq = self.ringpix == P
        self.eq_rows = rings[eq]
        cap_rows = rings[~eq]
        self.cap_rows = cap_rows
        ne = len(self.eq_rows)
        self.ne_pad = _pad_rows(ne)
        # padding rows read the (zero) last padding ring of Q
        self.eq_rows_pad = torch.as_tensor(np.concatenate(
            [self.eq_rows, np.full(self.ne_pad - ne, nrings_pad - 1)]),
            device=self.device)

        # --- synthesis cap buckets by length octave ---
        self.buckets = []
        if len(cap_rows):
            hi = 1 << int(np.ceil(np.log2(int(self.ringpix[cap_rows].max()))))
            while True:
                lo = hi // 2
                n = self.ringpix[cap_rows]
                sel = cap_rows[(n <= hi) if lo <= min_bucket_n
                               else (n > lo) & (n <= hi)]
                if len(sel):
                    self.buckets.append(self._make_bucket(sel, int(hi)))
                if lo <= min_bucket_n:
                    break
                hi = lo
        covered = np.concatenate([self.eq_rows]
                                 + [b["rows"] for b in self.buckets])
        assert np.array_equal(np.sort(covered), rings)

        # per-ring row base inside the concatenated v2 synthesis output
        base = np.zeros(self.nrings, dtype=np.int64)
        base[self.eq_rows] = np.arange(ne) * P
        off = self.ne_pad * P
        for b in self.buckets:
            base[b["rows"]] = off + np.arange(len(b["rows"])) * b["nmax"]
            off += b["rows_pad"] * b["nmax"]
        self.piece_base = base
        self.total_len = off

        # per-ring sin(theta) (closed form) for the turning-point cutoff
        r1 = rings + 1
        z = np.where(
            r1 < nside, 1.0 - r1**2 / (3.0 * nside**2),
            np.where(r1 > 3 * nside,
                     (4 * nside - r1) ** 2 / (3.0 * nside**2) - 1.0,
                     4.0 / 3.0 - 2.0 * r1 / (3.0 * nside)))
        self.sth_allrings = np.sqrt(np.maximum(1.0 - z * z, 0.0))

        # --- analysis cap groups by padded chirp-Z length ---
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
                b = self._make_bucket(sel, int(self.ringpix[sel].max()))
                nr, rows_pad, nmax = len(sel), b["rows_pad"], b["nmax"]
                b.update(K=int(Kr[Lkey == L].max()), Nk=nmax + B)
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
                b["bidx"] = torch.as_tensor(bidx.reshape(-1),
                                            device=self.device)
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
        self.m_int = torch.arange(nm, dtype=torch.int64, device=self.device)

    def _make_bucket(self, rows, nmax):
        """Rows (ascending), padded to a multiple of 8 with rows of length
        nmax that read the last padding ring."""
        nr = len(rows)
        nr_pad = _pad_rows(nr)
        nvec = np.full(nr_pad, nmax, dtype=np.int64)
        nvec[:nr] = self.ringpix[rows]
        rows_dev = np.concatenate([rows, np.full(nr_pad - nr,
                                                 self.nrings_pad - 1)])
        return dict(rows=rows, rows_pad=nr_pad, nmax=nmax, n=nvec,
                    L=2 * nmax, rows_dev=torch.as_tensor(rows_dev,
                                                         device=self.device))

    # ------------------------------------------------------------------
    # analysis
    # ------------------------------------------------------------------
    def _gather_rows_blocked(self, maps, k):
        """Aligned block-row gather for analysis group k: [..., rows_pad,
        nbl*B] with row r's ring pixels at columns [d_r, d_r + n_r), zeros
        elsewhere."""
        b, B = self.abuckets[k], self.B

        def build():
            j = torch.arange(b["nbl"] * B, device=self.device)[None, :]
            d = torch.as_tensor(b["d_host"], device=self.device)[:, None]
            n = torch.as_tensor(b["n"], device=self.device)[:, None]
            return (j >= d) & (j < d + n)

        mask = self.tables.get(("analysis_mask", k), build)
        mr = maps.reshape(maps.shape[:-1] + (self.npix // B, B))
        X = mr[..., b["bidx"], :]
        X = X.reshape(maps.shape[:-1] + (b["rows_pad"], b["nbl"] * B))
        return torch.where(mask, X, 0.0)

    def analysis(self, maps):
        """RING map(s) [..., npix] -> G [..., nrings_pad, nm] complex,

        G[r, m] = e^{-i m phi0_r} * DFT_{n_r}(x_r)[m mod n_r],

        assembled by concatenating contiguous ring ranges in ring order."""
        nm, P = self.nm, self.P
        lead = maps.shape[:-1]

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

        # cap groups: one chirp-Z per group emitting the first K frequencies
        # directly (the chirp DFT is n-periodic in m by construction)
        pieces = [(int(self.eq_rows[0]), Ge)]
        for k, b in enumerate(self.abuckets):
            Xb = self._gather_rows_blocked(maps, k)
            K = b["K"]
            Gb = czt_blocked(Xb, b["n"], K, b["L"], -1, self.cdtype,
                             b["rows_pad"], self.tables, ("analysis", k),
                             Nk=b["Nk"])
            if K < nm:
                Gb = torch.nn.functional.pad(Gb, (0, nm - K))
            # group rows = [north range..., south range..., padding]
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
        return times_phase(out, self.tables, ("phase_analysis",),
                           self.m_int, self.n_allrows, self.ashift, -1,
                           self.dtype, inplace=True)

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------
    def _belt(self, Y):
        """Belt rings of Y [..., nrings_pad, nm] -> [..., ne_pad * P] real
        (belt_rows on the belt's rows)."""
        return belt_rows(Y.index_select(-2, self.eq_rows_pad), self.P,
                         self.cdtype)

    def _fold_index(self, k):
        """int32 [jmax, rows_pad, nmax] flat index into Y [nrings_pad * nm]
        of v2 bucket k: entry (j, r, b) reads Y[row_r, b + j n_r] where b <
        n_r and b + j n_r < nm, else Y[nrings_pad - 1, 0] (zero)."""
        b, nm = self.buckets[k], self.nm
        nreal = b["n"][: len(b["rows"])]
        jmax = -(-nm // int(nreal.min()))
        dev = self.device
        bb = torch.arange(b["nmax"], device=dev)[None, None, :]
        jj = torch.arange(jmax, device=dev)[:, None, None]
        n = torch.as_tensor(b["n"], device=dev)[None, :, None]
        src = bb + jj * n
        ok = (src < nm) & (bb < n)
        row = b["rows_dev"].to(torch.int64)[None, :, None]
        zero = (self.nrings_pad - 1) * nm
        return torch.where(ok, row * nm + src, zero).to(torch.int32)

    def synthesis(self, Y):
        """v2: Y [..., nrings_pad, nm], the q rows times
        SHTPlan.synthesis_phase(), -> RING map(s) [..., npix] real,

        map(r, p) = Re sum_m Y_m e^{i m 2 pi p / n_r}.

        Belt by irfft; each cap bucket folds Y into m mod n bins through
        its fold index (the sum is n-periodic in m) and runs one chirp-Z;
        the pieces are assembled through one index.  The padding rows of
        the belt and the buckets, and the fold's empty entries, read the
        last padding ring of Y, which is zeroed here in place."""
        Y[..., self.nrings_pad - 1, :] = 0.0
        lead = Y.shape[:-2]
        Yf = Y.reshape(lead + (-1,))
        pieces = [self._belt(Y)]
        for k, b in enumerate(self.buckets):
            idx = self.tables.get(("fold", k), lambda: self._fold_index(k))
            q = Yf.index_select(-1, idx.reshape(-1))
            q = q.reshape(lead + idx.shape).sum(dim=-3)
            Xb = czt_blocked(q, b["n"], b["nmax"], b["L"], +1, self.cdtype,
                             _block(b["rows_pad"], b["L"]), self.tables,
                             ("v2", k), real=True)
            pieces.append(Xb.reshape(lead + (-1,)))
        idx = self.tables.get(("assembly", "v2"), lambda: pix2ring_index(
            self.startpix, self.piece_base, self.npix, self.device))
        return torch.cat(pieces, dim=-1).index_select(-1, idx)
