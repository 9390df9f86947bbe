"""SHT plan: host-built geometry and per-device tables for one HEALPix order.

Port of calclens_tpu/sht/plan.py (the reference's healpixsht_plan,
healpix_shtrans.c:54-160) for one device.  Per-ring quantities are padded to
nrings_pad rows; the northern ring-pair tables (index j: ring j north, ring
nrings-1-j south, j == J-1 the equator) live on the plan's device in the
plan's dtype.  O(npix) index tables are never built on the host: the ring
<-> map index maps are computed on the device from O(nrings) tables when
they are needed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from calclens_tpu.healpix import core as hp


class SHTPlan:
    """Static geometry + device tables for spherical-harmonic transforms.

    Parameters
    ----------
    order : HEALPix order of the map (nside = 2**order).
    device : torch device every table (and every transform input) lives on.
    lmax : band limit; defaults to 3*nside - 1 (reference healpix_shtrans.c:518).
    dtype : torch.float32 or torch.float64 (float64 on the CPU only: the
        CUDA kernels take float32).
    ring_weights : optional [2*nside] multiplicative quadrature ring-weight
        corrections per ring pair (1.0 = uniform).
    window : optional l-space window b_l applied in the Poisson filter.
    """

    def __init__(self, order, device, lmax=None, dtype=torch.float32,
                 ring_weights=None, window=None):
        self.order = int(order)
        self.nside = nside = 1 << self.order
        if nside > 8192:
            raise ValueError("chirp-Z phase arithmetic requires nside <= 8192")
        self.device = torch.device(device)
        self.npix = int(hp.order2npix(order))
        self.lmax = int(lmax) if lmax is not None else 3 * nside - 1
        self.nm = self.lmax + 1
        self.nl = self.lmax + 1
        self.nrings = 4 * nside - 1
        self.J = 2 * nside  # northern ring pairs incl. the equator
        self.P = 4 * nside  # max pixels per ring
        self.L = 8 * nside  # uniform chirp-Z FFT length (>= P + nm - 1)
        self.dtype = dtype
        self.cdtype = (torch.complex64 if dtype == torch.float32
                       else torch.complex128)
        # rings per synthesis chirp-Z block: bounds its [block, L] work arrays
        ring_block = max(64, min(4096, (1 << 26) // self.L))
        self.ring_block = min(ring_block, ((self.nrings + 63) // 64) * 64)
        self.nrings_pad = -(-self.nrings // self.ring_block) * self.ring_block

        rt = hp.build_ring_table(order)

        # --- host tables [nrings_pad] ---
        npr = np.full(self.nrings_pad, 4, dtype=np.int64)  # dummy pad rings
        npr[: self.nrings] = rt.ringpix
        start = np.zeros(self.nrings_pad, dtype=np.int64)
        start[: self.nrings] = rt.startpix
        self.startpix = start
        shifted = np.zeros(self.nrings_pad, dtype=np.int64)
        shifted[: self.nrings] = rt.shifted.astype(np.int64)
        theta = np.full(self.nrings_pad, np.pi / 2, dtype=np.float64)
        theta[: self.nrings] = rt.theta

        # quadrature weights: 4 pi / npix times the optional ring correction
        w = np.full(self.nrings_pad, 4.0 * np.pi / self.npix, dtype=np.float64)
        if ring_weights is not None:
            rw = np.asarray(ring_weights, dtype=np.float64)
            pair = np.minimum(np.arange(self.nrings),
                              self.nrings - 1 - np.arange(self.nrings))
            w[: self.nrings] *= rw[pair]
        w[self.nrings:] = 0.0

        ndt = np.float32 if dtype == torch.float32 else np.float64

        def dev(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=self.device)

        # --- northern ring-pair tables [J] ---
        jj = np.arange(self.J)
        th = rt.theta[jj]
        self.sth_host = np.sin(th)  # float64, for the turning-point cutoffs
        self.cth = dev(np.cos(th).astype(ndt))
        self.cot = dev((np.cos(th) / np.sin(th)).astype(ndt))
        self.inv_sth = dev((1.0 / np.sin(th)).astype(ndt))
        # ln(sin theta) evaluated in float64, then stored: the diagonal seed
        # multiplies it by m (up to ~24575)
        self.ln_sth = dev(np.log(np.sin(th)).astype(ndt))
        self.wN = dev(w[jj].astype(ndt))
        wS = w[self.nrings - 1 - jj].copy()
        wS[self.J - 1] = 0.0  # the equator has no southern partner
        self.wS = dev(wS.astype(ndt))

        # per-ring tables [nrings_pad] (host, in the plan dtype)
        self.sth_ring = np.sin(theta).astype(ndt)
        self.cot_ring = (np.cos(theta) / np.sin(theta)).astype(ndt)
        self.n_dev = dev(npr, torch.int64)
        self.shift_dev = dev(shifted, torch.int64)

        self.m_int = torch.arange(self.nm, dtype=torch.int64,
                                  device=self.device)
        self.m_f = self.m_int.to(dtype)
        # log of the diagonal seed's double-factorial ratio (legendre.py)
        from .legendre import logc_table

        self.logc = logc_table(self.nm, dtype, self.device)

        # optional l-space window b_l (pixel window / smoothing beam, the
        # reference's plan.window_function); None = no window
        if window is not None:
            wl = np.ones(self.nl, dtype=np.float64)
            wa = np.asarray(window, dtype=np.float64)
            wl[: min(self.nl, len(wa))] = wa[: self.nl]
            self.window_dev = dev(wl.astype(ndt))
        else:
            self.window_dev = None
        self._ring_stage = None

    def ring_stage(self):
        """The analysis ring-DFT stage (sht/rings.py), built on first use."""
        if self._ring_stage is None:
            from .rings import RingStage

            self._ring_stage = RingStage(self.order, self.nm, self.nrings_pad,
                                         self.device, dtype=self.dtype)
        return self._ring_stage

    def _pix2ring(self):
        """(ring index, offset in ring) of every map pixel, on the device."""
        p = torch.arange(self.npix, dtype=torch.int64, device=self.device)
        sp = torch.as_tensor(self.startpix[: self.nrings], device=self.device)
        r = torch.searchsorted(sp, p, right=True) - 1
        return r, p - sp[r]

    def rings_to_map(self, X):
        """[..., nrings_pad, P] ring matrix -> [..., npix] RING-ordered map."""
        r, off = self._pix2ring()
        idx = r * self.P + off
        del r, off
        flat = X.reshape(X.shape[:-2] + (self.nrings_pad * self.P,))
        return flat[..., idx]

    def ring_phase(self, sign):
        """exp(sign * i * m * phi0_r) [nrings_pad, nm] complex; the integer
        m * shift product is reduced mod 2n before the float conversion."""
        n = self.n_dev[:, None]
        t = (self.m_int[None, :] * self.shift_dev[:, None]) % (2 * n)
        ph = (math.pi * sign) * (t.to(self.dtype) / n.to(self.dtype))
        return torch.complex(torch.cos(ph), torch.sin(ph))
