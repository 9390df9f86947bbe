"""SHT plan: host-built geometry and per-device tables for one HEALPix order.

Port of calclens_tpu/sht/plan.py (the reference's healpixsht_plan,
healpix_shtrans.c:54-160) for one device.  Per-ring quantities are padded to
nrings_pad rows; the northern ring-pair tables (index j: ring j north, ring
nrings-1-j south, j == J-1 the equator) live on the plan's device in the
plan's dtype.  The tables of the ring stage that depend on the geometry
alone (chirp tables, the [nrings_pad, nm] phase tables, the ring <-> map
gather indices) are built on the device at their first use and kept in
the plan's TableCache (`plan.tables`), so later calls rebuild none of them;
a table larger than TABLE_MAX_BYTES is not kept but built per call, and a
phase table that large is applied in blocks of rows (times_phase), so at
order 13 no [nrings_pad, nm] table exists whole.
"""

from __future__ import annotations

import math
import os
import weakref

import numpy as np
import torch

from ..healpix import core as hp
from .czt import TableCache

# the synthesis ring stages (transforms.synthesis_rings)
SYNTHESIS_RINGS_MODES = ("uniform", "v2")
# the faster of the two on the H100 at order 12 (chip_smoke.py phase 9
# checks that it stays so)
DEFAULT_SYNTHESIS_RINGS_MODE = "v2"
# the largest table plan.tables keeps: every table up to order 12 (the
# largest, a [nrings_pad, nm] phase table, is 1.61 GB there); at order 13
# the phase tables (6.4 GB) and the ring <-> map indices (3.2-4.3 GB) are
# built per call instead (PERF.md)
TABLE_MAX_BYTES = 2 << 30
# rows per block of a phase table applied without the whole table
PHASE_ROWS = 1024


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

    Four attributes select kernels and ring stages, as the JAX package's
    switches do (a caller may set them on a built plan):
    synth_kernel : "k2" (default) or "k3" (JAX: plan.use_pallas_mx = False).
    analysis_kernel : "k1" (default) or "k4", which the environment variable
        CALCLENS_ANA_DOT=1 selects when the plan is built (JAX reads it when
        calclens_tpu/sht/pallas_legendre.py is imported).
    synthesis_rings_mode : the synthesis ring stage, one of
        SYNTHESIS_RINGS_MODES (default DEFAULT_SYNTHESIS_RINGS_MODE):
        "uniform" (one chirp-Z over all rings) or "v2" (belt irfft + cap
        chirp-Z buckets by length octave).  The JAX package's third mode,
        "hybrid" (belt irfft + one chirp-Z over all cap rings), is not
        ported: v2 beats it on the H100 (PERF.md).
    use_rings_v2 : the analysis ring stage: True (default) the bucketed
        stage of sht/rings.py, False the uniform chirp-Z over all rings.
    synth_stream : j-blocks of the streamed synthesis (transforms.
        synth_stream_blocks), or None for the per-order default; the
        environment variable CALCLENS_SYNTH_STREAM sets it when the plan is
        built.

    mesh : a parallel.sharding.Mesh, or None for one device.  On a mesh the
        plan knows this rank's m rows [m0, m1) (m_bounds), its ring rows
        [r0, r1) (ring_bounds) and their pixels (ring_pix_bounds), and its
        block of RING pixels (pix_bounds); the transforms take and return
        those blocks (transforms.py), and the ring stage builds its tables
        for this rank's rows only.
    """

    def __init__(self, order, device, lmax=None, dtype=torch.float32,
                 ring_weights=None, window=None, mesh=None):
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
        self.sth = dev(np.sin(th).astype(ndt))
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
        self.n_host = npr  # ring lengths, host copy for the table builds
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
        self._mcut = {}
        self._windows = {}
        self.tables = TableCache(self.device, max_bytes=TABLE_MAX_BYTES)
        self.synthesis_rings_mode = DEFAULT_SYNTHESIS_RINGS_MODE
        self.use_rings_v2 = True
        self.synth_kernel = "k2"
        self.analysis_kernel = ("k4" if os.environ.get("CALCLENS_ANA_DOT",
                                                       "0") == "1" else "k1")
        env = os.environ.get("CALCLENS_SYNTH_STREAM")
        self.synth_stream = int(env) if env else None
        self.mesh = mesh
        self.m0, self.m1 = 0, self.nm
        if mesh is not None:
            self.m_bounds = mesh.blocks(self.nm)
            self.m0, self.m1 = mesh.block(self.nm)
            self.ring_bounds = mesh.rings(self)
            sp = np.append(self.startpix[: self.nrings], self.npix)
            self.ring_pix_bounds = sp[self.ring_bounds]
            self.r0 = int(self.ring_bounds[mesh.rank])
            self.r1 = int(self.ring_bounds[mesh.rank + 1])
            self.pix_bounds = mesh.blocks(self.npix)

    def ring_stage(self):
        """The bucketed ring-DFT stage (sht/rings.py), built on first use;
        it keeps its tables in the plan's TableCache."""
        if self._ring_stage is None:
            from .rings import RingStage

            self._ring_stage = RingStage(self.order, self.nm, self.nrings_pad,
                                         self.device, self.tables,
                                         dtype=self.dtype)
        return self._ring_stage

    def mcut(self, tile_j):
        """The Legendre kernels' per-tile turning-point cutoff on tiles of
        `tile_j` ring pairs (legendre.tile_mcut), int32 on the plan's
        device, built once per tile width."""
        if tile_j not in self._mcut:
            from .legendre import tile_mcut

            self._mcut[tile_j] = torch.as_tensor(
                tile_mcut(self.sth_host, self.nl, self.nm, tile_j),
                device=self.device)
        return self._mcut[tile_j]

    def window(self, j0, j1):
        """The ring-pair geometry of columns [j0, j1) (RingPairWindow),
        made once per window; the whole plan for [0, J)."""
        if (j0, j1) == (0, self.J):
            return self
        if (j0, j1) not in self._windows:
            self._windows[(j0, j1)] = RingPairWindow(self, j0, j1)
        return self._windows[(j0, j1)]

    def rings_to_map(self, X):
        """[..., nrings_pad, P] ring matrix -> [..., npix] RING-ordered map."""
        idx = self.tables.get(("rings_to_map",), lambda: pix2ring_index(
            self.startpix[: self.nrings],
            np.arange(self.nrings, dtype=np.int64) * self.P, self.npix,
            self.device))
        flat = X.reshape(X.shape[:-2] + (self.nrings_pad * self.P,))
        return flat.index_select(-1, idx)

    def map_to_rings(self, m):
        """[..., npix] RING-ordered map -> [..., nrings_pad, P] ring matrix,
        zero beyond each ring's length and on the padding rings."""
        def build():
            j = torch.arange(self.P, device=self.device)[None, :]
            rows = torch.arange(self.nrings_pad, device=self.device)[:, None]
            mask = (j < self.n_dev[:, None]) & (rows < self.nrings)
            sp = torch.as_tensor(self.startpix, device=self.device)[:, None]
            idx = torch.where(mask, sp + j, 0).to(torch.int32).reshape(-1)
            return idx, mask

        idx, mask = self.tables.get(("map_to_rings",), build)
        X = m.index_select(-1, idx).reshape(m.shape[:-1] + mask.shape)
        return torch.where(mask, X, 0.0)

    def ring_phase(self, sign):
        """exp(sign * i * m * phi0_r) [nrings_pad, nm] complex."""
        return self.tables.get(("ring_phase", sign), lambda: phase_table(
            self.m_int, self.n_dev, self.shift_dev, sign, self.dtype))

    def synthesis_phase(self):
        """(2 - delta_m0) exp(i m phi0_r) [nrings_pad, nm]: the synthesis
        sum's m-fold weight and ring phase in one table, so a call pays one
        multiply (Y = Q * table)."""
        return self.tables.get(("synthesis_phase",), lambda: phase_table(
            self.m_int, self.n_dev, self.shift_dev, +1, self.dtype,
            mfold=True))

    def times_ring_phase(self, X, sign, mfold=False, inplace=False):
        """X [..., nrings_pad, nm] times ring_phase(sign) (mfold:
        synthesis_phase()) through times_phase: the cached table when it
        fits the plan's TableCache, else blocks of PHASE_ROWS rows."""
        key = ("synthesis_phase",) if mfold else ("ring_phase", sign)
        return times_phase(X, self.tables, key, self.m_int, self.n_dev,
                           self.shift_dev, sign, self.dtype, mfold, inplace)


class RingPairWindow:
    """The plan's ring-pair geometry restricted to columns [j0, j1): the
    unit of the streamed synthesis (calclens_tpu/sht/transforms.py::
    _geo_view).  It carries what transforms.legendre_synthesis reads of a
    plan: contiguous slices of the [J] tables (so the kernel wrappers'
    contiguity checks pass) and its own turning-point cutoffs, the
    kernels' per-tile cutoff over the window's rings (finer than the JAX
    window's single cutoff at granularity 512; both drop only lambda below
    float32 significance)."""

    def __init__(self, plan, j0, j1):
        if not 0 <= j0 < j1 <= plan.J:
            raise ValueError(f"window [{j0}, {j1}) outside [0, {plan.J})")
        # weak: the plan keeps its windows, and a cycle would keep the
        # plan's tables alive after its last reference until a gc pass
        self._plan = weakref.ref(plan)
        self.j0, self.j1, self.J = j0, j1, j1 - j0
        for name in ("order", "nl", "nm", "dtype", "cdtype", "device",
                     "m_f", "m_int", "logc", "mesh", "m0", "m1"):
            setattr(self, name, getattr(plan, name))
        for name in ("cth", "sth", "cot", "inv_sth", "ln_sth"):
            setattr(self, name, getattr(plan, name)[j0:j1].contiguous())
        self.sth_host = plan.sth_host[j0:j1]
        self._mcut = {}

    @property
    def synth_kernel(self):
        return self._plan().synth_kernel

    def mcut(self, tile_j):
        """legendre.tile_mcut over the window's own rings, from its first
        ring pair, int32 on the plan's device, built once per tile width."""
        if tile_j not in self._mcut:
            from .legendre import tile_mcut

            self._mcut[tile_j] = torch.as_tensor(
                tile_mcut(self.sth_host, self.nl, self.nm, tile_j),
                device=self.device)
        return self._mcut[tile_j]


def phase_table(m, n, shift, sign, dtype, mfold=False):
    """exp(sign * i * pi * m * shift_r / n_r) [rows, nm] complex for m [nm]
    and per-row n, shift [rows] (int64, on one device): the ring phase
    e^{sign i m phi0_r}.  The integer m * shift product is reduced mod 2n
    before the float conversion, so the cos/sin arguments stay below 2 pi
    at every m.  mfold=True multiplies by the synthesis weight 2 - delta_m0
    (exact: a power of two), so Q times the table equals Q times the weight
    times the phase bit for bit."""
    n = n[:, None]
    t = (m[None, :] * shift[:, None]) % (2 * n)
    ph = (math.pi * sign) * (t.to(dtype) / n.to(dtype))
    out = torch.complex(torch.cos(ph), torch.sin(ph))
    if mfold:
        out = out * torch.where(m == 0, 1.0, 2.0).to(dtype)[None, :]
    return out


def times_phase(X, tables, key, m, n, shift, sign, dtype, mfold=False,
                inplace=False):
    """X [..., R, nm] complex times phase_table(m, n, shift, sign, dtype,
    mfold) [R, nm]: with the table kept in `tables` under `key` when its
    bytes fit tables.max_bytes, else formed and applied PHASE_ROWS rows at
    a time, so the whole table never exists.  inplace=True writes into X
    (else X is left as it was)."""
    R = n.shape[0]
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    itemsize = torch.empty((), dtype=cdtype).element_size()
    if tables.keeps(R * m.shape[0] * itemsize):
        tab = tables.get(key, lambda: phase_table(m, n, shift, sign, dtype,
                                                  mfold))
        return X.mul_(tab) if inplace else X * tab
    out = X if inplace else torch.empty(X.shape, dtype=cdtype,
                                        device=X.device)
    for r in range(0, R, PHASE_ROWS):
        rs = slice(r, r + PHASE_ROWS)
        ph = phase_table(m, n[rs], shift[rs], sign, dtype, mfold)
        torch.mul(X[..., rs, :], ph, out=out[..., rs, :])
    return out


# pixels per block of pix2ring_index: bounds its int64 temporaries
PIX_CHUNK = 1 << 26


def pix2ring_index(startpix, base, npix, device, chunk=PIX_CHUNK):
    """int32 [npix]: base[ring(p)] + (p - startpix[ring(p)]), the gather
    index from ring rows laid out at offsets base [nrings] (host) to the
    RING-ordered map, built `chunk` pixels at a time (at order 13 a whole
    int64 pass over the pixels would take 6.4 GB per temporary).  int32
    holds npix and every offset up to order 13."""
    startpix = np.asarray(startpix, dtype=np.int64)
    base = np.asarray(base, dtype=np.int64)
    # the largest index: the last pixel of the ring that reaches furthest
    ends = np.append(startpix[1:], npix) - startpix
    if len(base) and int(np.max(base + ends - 1)) >= 2**31:
        raise ValueError("ring -> map index beyond int32")
    sp = torch.as_tensor(startpix, device=device)
    bs = torch.as_tensor(base, device=device)
    out = torch.empty(npix, dtype=torch.int32, device=device)
    for a in range(0, npix, chunk):
        p = torch.arange(a, min(npix, a + chunk), dtype=torch.int64,
                         device=device)
        r = torch.searchsorted(sp, p, right=True) - 1
        out[a: a + len(p)] = bs[r] + (p - sp[r])
    return out
