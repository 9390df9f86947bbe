"""Host-side HEALPix index machinery (vectorized numpy, int64).

The port's own copy of the part of calclens_tpu/healpix/core.py that it
calls: pixel counts, the per-ring geometry table of the SHT, RING pixel ->
unit vector, RING <-> NEST (the port imports nothing of the JAX package;
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


def pix2vec_ring(pix, order):
    return ang2vec(*pix2ang_ring(pix, order))


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
