"""Host-side HEALPix index machinery (vectorized numpy, int64).

The port's own copy of the part of calclens_tpu/healpix/core.py that it
calls: pixel counts, the per-ring geometry table of the SHT, angles <->
vectors <-> ra/dec, RING and NEST pixel <-> angle and vector, RING <-> NEST,
NEST <-> Peano index (the legacy restart files, the lens-plane files), the
host 4-pixel bilinear interpolation, NEST neighbours and the grid
triangulation (the galaxy image search), the ring-walk disc query (the SPH
oracle) (the port imports nothing of the JAX package;
tests/test_torch_copies.py holds the copy to the original).  Device-side
HEALPix work lives in torchhp.py.

Conventions (identical to HEALPix and the reference):
  * ``order``: nside = 2**order, npix = 12*4**order.
  * theta in [0, pi] measured from the north pole, phi in [0, 2pi).
  * RING ordering indexes pixels by iso-latitude ring from the north pole;
    NEST ordering indexes by base face and a z-order curve within the face.
"""

from __future__ import annotations

import numpy as np

# base-face row / phi offsets of the 12 HEALPix base pixels (standard tables)
JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


def order2nside(order):
    return np.int64(1) << order


def order2npix(order):
    return np.int64(12) << (2 * order)


def ang2vec(theta, phi):
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=-1)


def vec2ang(vec):
    vec = np.asarray(vec, dtype=np.float64)
    r = np.sqrt(np.sum(vec * vec, axis=-1))
    theta = np.arccos(np.clip(vec[..., 2] / r, -1.0, 1.0))
    phi = np.arctan2(vec[..., 1], vec[..., 0])
    phi = np.where(phi < 0.0, phi + 2.0 * np.pi, phi)
    return theta, phi


def ang2radec(theta, phi):
    return np.degrees(phi), 90.0 - np.degrees(theta)


def radec2ang(ra, dec):
    return np.radians(90.0 - np.asarray(dec, dtype=np.float64)), np.radians(ra)


def vec2radec(vec):
    theta, phi = vec2ang(vec)
    return ang2radec(theta, phi)


def radec2vec(ra, dec):
    theta, phi = radec2ang(ra, dec)
    return ang2vec(theta, phi)


def _isqrt(x):
    """Exact integer sqrt for int64 inputs (float sqrt + correction)."""
    x = np.asarray(x, dtype=np.int64)
    r = np.asarray(np.sqrt(x.astype(np.float64)), dtype=np.float64).astype(np.int64)
    r = np.where((r + 1) * (r + 1) <= x, r + 1, r)
    r = np.where(r * r > x, r - 1, r)
    return r


def pix2ring(pix, order):
    """RING pixel index -> (iring, iphi, kshift, nr).

    iring in [1, 4nside-1] counted from the north pole; iphi in [1, 4*nr];
    kshift is 1 when the ring is shifted by half a pixel width; nr is the
    number of pixels in the ring divided by 4.
    """
    nside = order2nside(order)
    npix = order2npix(order)
    ncap = 2 * nside * (nside - 1)
    pix = np.asarray(pix, dtype=np.int64)

    north = pix < ncap
    south = pix >= (npix - ncap)
    # north cap
    iring_n = (1 + _isqrt(1 + 2 * pix)) >> 1
    iphi_n = pix + 1 - 2 * iring_n * (iring_n - 1)
    # equatorial
    ip = pix - ncap
    tmp = ip >> (order + 2)
    iring_e = tmp + nside
    iphi_e = ip - tmp * 4 * nside + 1
    kshift_e = (iring_e + nside) & 1
    # south cap
    ip_s = npix - pix
    iring_s_local = (1 + _isqrt(2 * ip_s - 1)) >> 1
    iphi_s = 4 * iring_s_local + 1 - (ip_s - 2 * iring_s_local * (iring_s_local - 1))
    iring_s = 4 * nside - iring_s_local

    iring = np.where(north, iring_n, np.where(south, iring_s, iring_e))
    iphi = np.where(north, iphi_n, np.where(south, iphi_s, iphi_e))
    nr = np.where(north, iring_n, np.where(south, iring_s_local, nside))
    # cap rings are always shifted; equatorial rings when (iring+nside) even
    kshift = np.where(north | south, np.int64(1), 1 - kshift_e)
    return iring, iphi, kshift, nr


def pix2ang_ring(pix, order):
    nside = int(order2nside(order))
    iring, iphi, kshift, nr = pix2ring(pix, order)
    north_or_south_cap = nr != nside
    zcap = 1.0 - (nr.astype(np.float64) ** 2) / (3.0 * nside * nside)
    zcap = np.where(iring > 2 * nside, -zcap, zcap)
    zeq = 4.0 / 3.0 - 2.0 * iring.astype(np.float64) / (3.0 * nside)
    z = np.where(north_or_south_cap, zcap, zeq)
    fodd = 0.5 * kshift.astype(np.float64)  # shifted rings offset by half pixel
    phi = (iphi.astype(np.float64) - 1.0 + fodd) * np.pi / (2.0 * nr.astype(np.float64))
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    return theta, phi


def ang2pix_ring(theta, phi, order):
    nside = int(order2nside(order))
    npix = int(order2npix(order))
    ncap = 2 * nside * (nside - 1)
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) * (2.0 / np.pi)  # in [0,4)

    # equatorial strip
    temp1 = nside * (0.5 + tt)
    temp2 = nside * z * 0.75
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    ir = nside + 1 + jp - jm  # ring number counted from z = 2/3, in {1, 2n+1}
    kshift = 1 - (ir & 1)
    ipe = (jp + jm - nside + kshift + 1) >> 1
    ipe = np.mod(ipe, 4 * nside)
    pix_eq = ncap + (ir - 1) * 4 * nside + ipe

    # polar caps
    tp = tt - np.floor(tt)
    tmp = nside * np.sqrt(np.maximum(3.0 * (1.0 - za), 0.0))
    jp_c = np.floor(tp * tmp).astype(np.int64)
    jm_c = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir_c = jp_c + jm_c + 1
    ip_c = np.floor(tt * ir_c).astype(np.int64)
    ip_c = np.mod(ip_c, 4 * ir_c)
    pix_north = 2 * ir_c * (ir_c - 1) + ip_c
    pix_south = npix - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = np.where(z > 0, pix_north, pix_south)

    return np.where(za <= 2.0 / 3.0, pix_eq, pix_cap)


def pix2vec_ring(pix, order):
    return ang2vec(*pix2ang_ring(pix, order))


def vec2pix_ring(vec, order):
    return ang2pix_ring(*vec2ang(vec), order)


def _spread_bits(v):
    """Interleave zeros: bit i of v -> bit 2i of result (int64, 32-bit input)."""
    x = np.asarray(v, dtype=np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x.astype(np.int64)


def _compress_bits(v):
    """Inverse of _spread_bits: keep even bits, pack them."""
    x = np.asarray(v, dtype=np.uint64) & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x.astype(np.int64)


def xyf2nest(x, y, f, order):
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    f = np.asarray(f, dtype=np.int64)
    return (f << (2 * order)) + _spread_bits(x) + (_spread_bits(y) << 1)


def nest2xyf(pix, order):
    pix = np.asarray(pix, dtype=np.int64)
    npface = np.int64(1) << (2 * order)
    f = pix >> (2 * order)
    p = pix & (npface - 1)
    x = _compress_bits(p)
    y = _compress_bits(p >> 1)
    return x, y, f


def ring2xyf(pix, order):
    nside = order2nside(order)
    npix = order2npix(order)
    ncap = 2 * nside * (nside - 1)
    pix = np.asarray(pix, dtype=np.int64)

    north = pix < ncap
    south = pix >= npix - ncap

    # north cap
    iring_n = (1 + _isqrt(1 + 2 * pix)) >> 1
    iphi_n = pix + 1 - 2 * iring_n * (iring_n - 1)
    face_n = (iphi_n - 1) // np.maximum(iring_n, 1)
    nr_n = iring_n
    kshift_n = np.zeros_like(pix)

    # equatorial
    ip = pix - ncap
    tmp = ip >> (order + 2)
    iring_e = tmp + nside
    iphi_e = ip - tmp * 4 * nside + 1
    kshift_e = (iring_e + nside) & 1
    nr_e = np.full_like(pix, nside)
    ire = iring_e - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = (iphi_e - ire // 2 + nside - 1) >> order
    ifp = (iphi_e - irm // 2 + nside - 1) >> order
    face_e = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))

    # south cap
    ip_s = npix - pix
    iring_sl = (1 + _isqrt(2 * ip_s - 1)) >> 1
    iphi_s = 4 * iring_sl + 1 - (ip_s - 2 * iring_sl * (iring_sl - 1))
    face_s = 8 + (iphi_s - 1) // np.maximum(iring_sl, 1)
    iring_s = 4 * nside - iring_sl
    nr_s = iring_sl
    kshift_s = np.zeros_like(pix)

    iring = np.where(north, iring_n, np.where(south, iring_s, iring_e))
    iphi = np.where(north, iphi_n, np.where(south, iphi_s, iphi_e))
    kshift = np.where(north, kshift_n, np.where(south, kshift_s, kshift_e))
    nr = np.where(north, nr_n, np.where(south, nr_s, nr_e))
    face = np.where(north, face_n, np.where(south, face_s, face_e))

    irt = iring - JRLL[face] * nside + 1
    ipt = 2 * iphi - JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    x = (ipt - irt) >> 1
    y = (-ipt - irt) >> 1
    return x, y, face


def xyf2ring(x, y, f, order):
    nside = order2nside(order)
    npix = order2npix(order)
    ncap = 2 * nside * (nside - 1)
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    f = np.asarray(f, dtype=np.int64)

    jr = JRLL[f] * nside - x - y - 1
    north = jr < nside
    south = jr > 3 * nside

    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    n_before = np.where(
        north,
        2 * nr * (nr - 1),
        np.where(south, npix - 2 * (nr + 1) * nr, ncap + (jr - nside) * 4 * nside),
    )
    kshift = np.where(north | south, np.int64(0), (jr - nside) & 1)

    jp = (JPLL[f] * nr + x - y + 1 + kshift) >> 1
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def nest2ring(pix, order):
    return xyf2ring(*nest2xyf(pix, order), order)


def ring2nest(pix, order):
    x, y, f = ring2xyf(pix, order)
    return xyf2nest(x, y, f, order)


def pix2ang_nest(pix, order):
    return pix2ang_ring(nest2ring(pix, order), order)


def ang2pix_nest(theta, phi, order):
    return ring2nest(ang2pix_ring(theta, phi, order), order)


def pix2vec_nest(pix, order):
    return ang2vec(*pix2ang_nest(pix, order))


def vec2pix_nest(vec, order):
    return ring2nest(vec2pix_ring(vec, order), order)


# ----------------------------------------------------------------------------
# Peano curve (nest <-> peano), standard Healpix_cxx algorithm
# ----------------------------------------------------------------------------
# The Peano index orders nest pixels along a Hilbert-like space filling curve;
# it is the cell ordering of the indexed lens-plane file format.  The curve is
# defined by an 8-state automaton over child quadrants (the classic
# Healpix_cxx definition the reference inherits): state tables give, for each
# curve state ("path") and nest child index, the position along the curve and
# the child's state.

_SUBPIX = np.array([
    [0, 1, 3, 2], [3, 0, 2, 1], [2, 3, 1, 0], [1, 2, 0, 3],
    [0, 3, 1, 2], [1, 0, 2, 3], [2, 1, 3, 0], [3, 2, 0, 1],
], dtype=np.int64)
_SUBPATH = np.array([
    [4, 0, 6, 0], [7, 5, 1, 1], [2, 4, 2, 6], [3, 3, 7, 5],
    [0, 2, 4, 4], [5, 1, 5, 3], [6, 6, 0, 2], [1, 7, 3, 7],
], dtype=np.int64)
_FACE2PATH = np.array([2, 5, 2, 5, 3, 6, 3, 6, 2, 3, 2, 3], dtype=np.int64)
_FACE2PEANOFACE = np.array([0, 5, 6, 11, 10, 1, 4, 7, 2, 3, 8, 9], dtype=np.int64)


def nest2peano(pix, order):
    pix = np.asarray(pix, dtype=np.int64)
    face = pix >> (2 * order)
    path = _FACE2PATH[face].copy()
    result = np.zeros_like(pix)
    for shift in range(2 * order - 2, -2, -2):
        spix = (pix >> shift) & 3
        result = (result << 2) | _SUBPIX[path, spix]
        path = _SUBPATH[path, spix]
    return result + (_FACE2PEANOFACE[face] << (2 * order))


def _peano_inverse_tables():
    """The automaton run backwards: (curve position -> nest child, its
    state) per state, and the face and state of each Peano face."""
    subpix_inv = np.zeros_like(_SUBPIX)
    subpath_inv = np.zeros_like(_SUBPATH)
    for s in range(8):
        for c in range(4):
            out = _SUBPIX[s, c]
            subpix_inv[s, out] = c
            subpath_inv[s, out] = _SUBPATH[s, c]
    pf2f = np.zeros(12, dtype=np.int64)
    pf2p = np.zeros(12, dtype=np.int64)
    for f in range(12):
        pf2f[_FACE2PEANOFACE[f]] = f
        pf2p[_FACE2PEANOFACE[f]] = _FACE2PATH[f]
    return subpix_inv, subpath_inv, pf2f, pf2p


(_PEANO_SUBPIX_INV, _PEANO_SUBPATH_INV, _PEANOFACE2FACE,
 _PEANOFACE2PATH) = _peano_inverse_tables()


def peano2nest(pix, order):
    pix = np.asarray(pix, dtype=np.int64)
    pface = pix >> (2 * order)
    path = _PEANOFACE2PATH[pface].copy()
    result = np.zeros_like(pix)
    for shift in range(2 * order - 2, -2, -2):
        spix = (pix >> shift) & 3
        result = (result << 2) | _PEANO_SUBPIX_INV[path, spix]
        path = _PEANO_SUBPATH_INV[path, spix]
    return result + (_PEANOFACE2FACE[pface] << (2 * order))


class RingTable:
    """Static per-ring geometry for a given order (the analog of the
    reference's ``get_ring_info2``, healpix_utils.h:103).

    Attributes are numpy arrays of length nrings = 4*nside - 1, indexed by
    ring number minus one (ring 1 at the north pole):
      startpix  first RING-ordered pixel index of the ring
      ringpix   number of pixels in the ring
      z, theta  cos(colatitude) and colatitude of the ring centre
      shifted   True when first pixel sits at phi = pi/ringpix (half shifted)
    """

    def __init__(self, order):
        self.order = order
        nside = int(order2nside(order))
        self.nside = nside
        self.npix = int(order2npix(order))
        nrings = 4 * nside - 1
        self.nrings = nrings
        i = np.arange(1, nrings + 1, dtype=np.int64)
        ncap = 2 * nside * (nside - 1)
        npix = self.npix

        northcap = i < nside
        southcap = i > 3 * nside
        nr = np.where(northcap, i, np.where(southcap, 4 * nside - i, nside))
        self.ringpix = 4 * nr
        start_n = 2 * i * (i - 1)
        start_e = ncap + (i - nside) * 4 * nside
        isouth = 4 * nside - i
        start_s = npix - 2 * isouth * (isouth + 1)
        self.startpix = np.where(northcap, start_n, np.where(southcap, start_s, start_e))

        z_n = 1.0 - (i.astype(np.float64) ** 2) / (3.0 * nside**2)
        z_e = 4.0 / 3.0 - 2.0 * i.astype(np.float64) / (3.0 * nside)
        z_s = -1.0 + (isouth.astype(np.float64) ** 2) / (3.0 * nside**2)
        self.z = np.where(northcap, z_n, np.where(southcap, z_s, z_e))
        self.theta = np.arccos(np.clip(self.z, -1.0, 1.0))
        # caps always shifted; equatorial shifted when (i+nside) even
        self.shifted = np.where(
            northcap | southcap, True, ((i + nside) & 1) == 0
        ).astype(bool)


_ring_table_cache = {}


def build_ring_table(order) -> RingTable:
    rt = _ring_table_cache.get(order)
    if rt is None:
        rt = RingTable(order)
        _ring_table_cache[order] = rt
    return rt


def query_disc(theta, phi, radius, order, fact=2):
    """Return RING pixel indices whose centers may fall within ``radius`` of
    (theta, phi), inclusive of boundary pixels (coarse, conservative).

    Host-side utility used for buffer-region marking and SPH deposits during
    setup (reference healpix_fastdiscquery.c:30).  Simple ring-walk version.
    """
    rt = build_ring_table(order)
    # inclusive: pad by the max pixel radius ~ pixel diagonal
    pad = np.pi / (4.0 * rt.nside) * 1.4143
    cosrad = np.cos(min(radius + pad, np.pi))
    out = []
    z0 = np.cos(theta)
    sin0 = np.sqrt(max(0.0, 1.0 - z0 * z0))
    for iring in range(1, rt.nrings + 1):
        idx = iring - 1
        zr = rt.z[idx]
        sr = np.sqrt(max(0.0, 1.0 - zr * zr))
        # cos of angular distance from (theta,phi) to ring point at dphi:
        # cosd = z0*zr + sin0*sr*cos(dphi) ; need cosd >= cosrad
        denom = sin0 * sr
        num = cosrad - z0 * zr
        if denom <= 0.0:
            if num <= 0.0:
                dphi_max = np.pi
            else:
                continue
        else:
            c = num / denom
            if c >= 1.0:
                continue
            dphi_max = np.pi if c <= -1.0 else np.arccos(c)
        nr = rt.ringpix[idx]
        shift = 0.5 if rt.shifted[idx] else 0.0
        ip_lo = int(np.ceil(nr * (phi - dphi_max) / (2 * np.pi) - shift))
        ip_hi = int(np.floor(nr * (phi + dphi_max) / (2 * np.pi) - shift))
        if ip_hi < ip_lo:
            continue
        ips = np.arange(ip_lo, ip_hi + 1, dtype=np.int64) % nr
        out.append(rt.startpix[idx] + np.unique(ips))
    if not out:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(out)


# ----------------------------------------------------------------------------
# bilinear interpolation (reference get_interpol, healpix_utils.h:107)
# ----------------------------------------------------------------------------

def get_interpol(theta, phi, order):
    """4-pixel bilinear interpolation weights on the RING grid.

    Returns (pix[...,4] int64 RING indices, wgt[...,4] float64).  Standard
    HEALPix scheme: the two rings bracketing theta contribute two pixels each,
    linearly weighted in phi along the ring and in theta across rings; at the
    poles the weights are folded onto the nearest ring.
    """
    rt = build_ring_table(order)
    nside = rt.nside
    npix = rt.npix
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    z = np.cos(theta)

    # ring_above: largest ring index whose z is >= given z (0 = none above)
    az = np.abs(z)
    ir_cap = (nside * np.sqrt(3.0 * (1.0 - az))).astype(np.int64)
    ir_eq = (nside * (2.0 - 1.5 * z)).astype(np.int64)
    ring_above = np.where(
        az <= 2.0 / 3.0, ir_eq, np.where(z > 0, ir_cap, 4 * nside - ir_cap - 1)
    )

    ir1 = ring_above
    ir2 = ring_above + 1

    def ring_interp(ir):
        """pixel pair (absolute i1, i2) and frac weight w along ring ir."""
        idx = np.clip(ir, 1, rt.nrings) - 1
        sp = rt.startpix[idx]
        nr = rt.ringpix[idx]
        shift = np.where(rt.shifted[idx], 0.5, 0.0)
        dphi = 2.0 * np.pi / nr
        tmp = phi / dphi - shift
        i1 = np.floor(tmp).astype(np.int64)
        w = (phi - (i1 + shift) * dphi) / dphi
        i2 = i1 + 1
        i1 = np.where(i1 < 0, i1 + nr, i1)
        i2 = np.where(i2 >= nr, i2 - nr, i2)
        return sp + i1, sp + i2, w

    p11, p12, w1 = ring_interp(ir1)
    p21, p22, w2 = ring_interp(ir2)
    theta1 = rt.theta[np.clip(ir1, 1, rt.nrings) - 1]
    theta2 = rt.theta[np.clip(ir2, 1, rt.nrings) - 1]

    pix = np.zeros(theta.shape + (4,), dtype=np.int64)
    wgt = np.zeros(theta.shape + (4,), dtype=np.float64)
    pix[..., 0], pix[..., 1] = p11, p12
    pix[..., 2], pix[..., 3] = p21, p22

    north = ir1 == 0
    south = ir2 == 4 * nside
    generic = ~(north | south)

    # generic: bilinear between the two rings
    wtheta_g = (theta - theta1) / np.where(theta2 != theta1, theta2 - theta1, 1.0)
    wgt[..., 0] = np.where(generic, (1.0 - wtheta_g) * (1.0 - w1), 0.0)
    wgt[..., 1] = np.where(generic, (1.0 - wtheta_g) * w1, 0.0)
    wgt[..., 2] = np.where(generic, wtheta_g * (1.0 - w2), 0.0)
    wgt[..., 3] = np.where(generic, wtheta_g * w2, 0.0)

    if np.any(north):
        wth = theta / theta2
        fac = (1.0 - wth) * 0.25
        wgt[north, 0] = fac[north]
        wgt[north, 1] = fac[north]
        wgt[north, 2] = (wth * (1.0 - w2))[north] + fac[north]
        wgt[north, 3] = (wth * w2)[north] + fac[north]
        pix[north, 0] = (p21[north] + 2) % 4
        pix[north, 1] = (p22[north] + 2) % 4
    if np.any(south):
        wth = (theta - theta1) / (np.pi - theta1)
        fac = wth * 0.25
        wgt[south, 0] = ((1.0 - wth) * (1.0 - w1))[south] + fac[south]
        wgt[south, 1] = ((1.0 - wth) * w1)[south] + fac[south]
        wgt[south, 2] = fac[south]
        wgt[south, 3] = fac[south]
        pix[south, 2] = ((p11[south] + 2) & 3) + npix - 4
        pix[south, 3] = ((p12[south] + 2) & 3) + npix - 4

    return pix, wgt


# ----------------------------------------------------------------------------
# nest neighbours and the grid triangulation (the galaxy image search)
# ----------------------------------------------------------------------------

_NB_XOFFSET = np.array([-1, -1, 0, 1, 1, 1, 0, -1], dtype=np.int64)
_NB_YOFFSET = np.array([0, 1, 1, 1, 0, -1, -1, -1], dtype=np.int64)
_NB_FACEARRAY = np.array([
    [8, 9, 10, 11, -1, -1, -1, -1, 10, 11, 8, 9],
    [5, 6, 7, 4, 8, 9, 10, 11, 9, 10, 11, 8],
    [-1, -1, -1, -1, 5, 6, 7, 4, -1, -1, -1, -1],
    [4, 5, 6, 7, 11, 8, 9, 10, 11, 8, 9, 10],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
    [1, 2, 3, 0, 0, 1, 2, 3, 5, 6, 7, 4],
    [-1, -1, -1, -1, 7, 4, 5, 6, -1, -1, -1, -1],
    [3, 0, 1, 2, 3, 0, 1, 2, 4, 5, 6, 7],
    [2, 3, 0, 1, -1, -1, -1, -1, 0, 1, 2, 3],
], dtype=np.int64)
_NB_SWAPARRAY = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 3, 3],
    [0, 0, 0, 0, 0, 0, 0, 0, 6, 6, 6, 6],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 5, 5, 5, 5],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [5, 5, 5, 5, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [6, 6, 6, 6, 0, 0, 0, 0, 0, 0, 0, 0],
    [3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0],
], dtype=np.int64)


def neighbors_nest(pix, order):
    """8 nest-scheme neighbors (SW, W, NW, N, NE, E, SE, S); -1 where absent.

    Standard Healpix_cxx neighbor algorithm vectorized over pixels.
    """
    nside = int(order2nside(order))
    x, y, f = nest2xyf(pix, order)
    x = np.atleast_1d(x)
    y = np.atleast_1d(y)
    f = np.atleast_1d(f)
    n = x.shape[0]
    result = np.full((n, 8), -1, dtype=np.int64)
    for i in range(8):
        xn = x + _NB_XOFFSET[i]
        yn = y + _NB_YOFFSET[i]
        inside = (xn >= 0) & (xn < nside) & (yn >= 0) & (yn < nside)
        result[inside, i] = xyf2nest(xn[inside], yn[inside], f[inside], order)
        edge = ~inside
        if np.any(edge):
            nbnum = np.full(n, 4, dtype=np.int64)
            nbnum = np.where(xn < 0, nbnum - 1, nbnum)
            nbnum = np.where(xn >= nside, nbnum + 1, nbnum)
            nbnum = np.where(yn < 0, nbnum - 3, nbnum)
            nbnum = np.where(yn >= nside, nbnum + 3, nbnum)
            fn = _NB_FACEARRAY[nbnum, f]
            ok = edge & (fn >= 0)
            if np.any(ok):
                bits = _NB_SWAPARRAY[nbnum, f]
                xi = np.mod(xn, nside)
                yi = np.mod(yn, nside)
                xs = np.where(bits & 1, nside - xi - 1, xi)
                ys = np.where(bits & 2, nside - yi - 1, yi)
                xf = np.where(bits & 4, ys, xs)
                yf = np.where(bits & 4, xs, ys)
                result[ok, i] = xyf2nest(xf[ok], yf[ok], fn[ok], order)
    return result


# ----------------------------------------------------------------------------
# grid triangulation (reference ring2triangle, healpix_utils.c:1273-1423)
# ----------------------------------------------------------------------------

def build_triangles(order):
    """Triangulation of the pixel-center grid: tri [npix, 4, 3] RING pixel
    indices, -1-padded.  Triangle slot 0 of pixel p is (p, right-neighbor,
    above-ring pixel); slots 1-2 close the strip toward the ring above; the
    polar rings carry the cap-closing triangles.  The full table tiles the
    sphere: exactly 2*npix - 4 triangles (Euler).  Vectorized host port of
    the reference's per-pixel ring2triangle.
    """
    rt = build_ring_table(order)
    nside, npix = rt.nside, rt.npix
    pix = np.arange(npix, dtype=np.int64)
    ringnum = np.searchsorted(rt.startpix, pix, side="right")  # 1-based
    sp = rt.startpix[ringnum - 1]
    Np = rt.ringpix[ringnum - 1]
    sh = rt.shifted[ringnum - 1].astype(np.int64)
    ip = pix - sp
    ringA = ringnum - 1
    iA = np.clip(ringA, 1, rt.nrings) - 1
    spA = rt.startpix[iA]
    NpA = rt.ringpix[iA]

    tri = np.full((npix, 4, 3), -1, dtype=np.int64)
    right = (ip + 1) % Np + sp

    def put(mask, slot, a, b, c):
        tri[mask, slot, 0] = a[mask] if a.shape else a
        tri[mask, slot, 1] = b[mask]
        tri[mask, slot, 2] = c[mask]

    # north polar cap rings 2..nside
    m = (ringnum >= 2) & (ringnum <= nside)
    ib = ip % np.maximum(ringnum, 1)
    bnum = ip // np.maximum(ringnum, 1)
    interior = ib < ringnum - 1
    X_int = (ib + bnum * ringA) % NpA + spA
    X_cor = (ib + bnum * ringA - 1) % NpA + spA
    X = np.where(interior, X_int, X_cor)
    put(m, 0, pix, right, X)
    X2 = (X_int - spA - 1) % NpA + spA
    put(m & interior, 1, pix, X_int, X2)

    # equatorial rings nside+1 .. 3*nside
    me = (ringnum > nside) & (ringnum <= 3 * nside)
    ibe = ip % nside
    bne = ip // nside
    above_nr = np.where(ringA > nside, nside, ringA)
    Xe = (sh + ibe + bne * above_nr) % NpA + spA
    Xe2 = (Xe - spA - 1) % NpA + spA
    put(me, 0, pix, right, Xe)
    put(me, 1, pix, Xe, Xe2)

    # south polar cap rings 3*nside+1 .. 4*nside-1
    ms = ringnum > 3 * nside
    nring = np.maximum(4 * nside - ringnum, 1)
    nringA = np.maximum(4 * nside - ringA, 1)
    ibs = ip % nring
    bns = ip // nring
    Xs = (sh + ibs + bns * nringA) % NpA + spA
    Xs2 = (Xs - spA - 1) % NpA + spA
    Xs3 = (Xs2 - spA - 1) % NpA + spA
    put(ms, 0, pix, right, Xs)
    put(ms, 1, pix, Xs, Xs2)
    put(ms & (ibs == 0), 2, pix, Xs2, Xs3)

    # north pole cap-closers (ring 1: pixels 0..3)
    tri[0, 0] = (0, 2, 3)
    tri[1, 0] = -1
    tri[2, 0] = (2, 0, 1)
    tri[3, 0] = -1
    # reference only emits the two closers for ring-1 pixels; clear any strip
    # entries the cap formulas would not produce
    tri[0, 1:] = -1
    tri[1, :] = -1
    tri[2, 1:] = -1
    tri[3, :] = -1

    # south pole cap-closers appended at the pixels' next free slot
    last = ringnum == 4 * nside - 1
    for p, t in ((npix - 1, (npix - 1, npix - 3, npix - 4)),
                 (npix - 3, (npix - 3, npix - 2, npix - 1))):
        slot = int(np.sum(tri[p, :, 0] >= 0))
        tri[p, slot] = t
    del last
    return tri
