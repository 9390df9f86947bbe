"""Device-side HEALPix geometry on torch tensors (RING scheme).

Port of calclens_tpu/healpix/jaxhp.py: RING ang->pix (particle deposit),
pix->unit vector, pixel -> (ring, index) decode, closed-form ring geometry,
the 4-pixel bilinear taps of get_interpol, and NEST <-> RING for the lens
maps.  Integer work is int64 (exact for every order <= 13), except the NEST
<-> RING functions, which are int32 like the JAX ones; floats follow the
input dtype.  Host-side code uses
healpix/core.py (numpy) instead.

Numerical care in float32: polar-cap z is computed via 1 - |z| (an exact
small quantity) so sin(theta) stays accurate near the poles, and the integer
square root is float-then-correct so ring decoding is exact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import core as hp
from ..utils.profile import count


def _isqrt_dev(x):
    """Exact integer sqrt for integer x < 2^31."""
    r = torch.sqrt(x.to(torch.float32)).to(x.dtype)
    r = torch.where((r + 1) * (r + 1) <= x, r + 1, r)
    return torch.where(r * r > x, r - 1, r)


def ang2pix_ring(theta, phi, order: int):
    """Vectorized RING ang2pix (healpix_utils ang2ring parity)."""
    nside = 1 << order
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    z = torch.cos(theta)
    za = z.abs()
    tt = torch.remainder(phi, 2.0 * math.pi) * (2.0 / math.pi)

    temp1 = nside * (0.5 + tt)
    temp2 = nside * z * 0.75
    jp = torch.floor(temp1 - temp2).long()
    jm = torch.floor(temp1 + temp2).long()
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    ipe = (jp + jm - nside + kshift + 1) >> 1
    ipe = torch.remainder(ipe, 4 * nside)
    pix_eq = ncap + (ir - 1) * 4 * nside + ipe

    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(torch.clamp(3.0 * (1.0 - za), min=0.0))
    jp_c = torch.floor(tp * tmp).long()
    jm_c = torch.floor((1.0 - tp) * tmp).long()
    ir_c = jp_c + jm_c + 1
    ip_c = torch.floor(tt * ir_c).long()
    ip_c = torch.remainder(ip_c, 4 * ir_c)
    pix_cap = torch.where(z > 0, 2 * ir_c * (ir_c - 1) + ip_c,
                          npix - 2 * ir_c * (ir_c + 1) + ip_c)
    return torch.where(za <= 2.0 / 3.0, pix_eq, pix_cap)


def vec2ang(vec):
    """[..., 3] vectors (any length) -> (theta, phi) with phi in [0, 2 pi)."""
    r = torch.linalg.vector_norm(vec, dim=-1)
    theta = torch.arccos(torch.clamp(vec[..., 2] / r, -1.0, 1.0))
    phi = torch.atan2(vec[..., 1], vec[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return theta, phi


def vec2pix_ring(vec, order: int):
    theta, phi = vec2ang(vec)
    return ang2pix_ring(theta, phi, order)


def pix2vec_ring(pix, order: int, dtype=torch.float32):
    """RING pix -> unit vector [..., 3], pole-stable."""
    return torch.stack(pix2vec_ring_soa(pix, order, dtype), dim=-1)


def pix2vec_ring_soa(pix, order: int, dtype=torch.float32):
    """RING pix -> unit vector components (x, y, z), pole-stable (uses
    1 - |z| in the caps); no trailing length-3 axis is materialized."""
    nside = 1 << order
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    pix = pix.long()

    north = pix < ncap
    south = pix >= npix - ncap

    iring_n = (1 + _isqrt_dev(1 + 2 * pix)) >> 1
    iphi_n = pix + 1 - 2 * iring_n * (iring_n - 1)
    ip_s = npix - pix
    iring_s = (1 + _isqrt_dev(2 * ip_s - 1)) >> 1
    iphi_s = 4 * iring_s + 1 - (ip_s - 2 * iring_s * (iring_s - 1))
    ip_e = pix - ncap
    tmp = ip_e >> (order + 2)
    iring_e = tmp + nside
    iphi_e = ip_e - tmp * 4 * nside + 1
    fodd = torch.where((iring_e + nside) & 1 != 0, 1.0, 0.5).to(dtype)

    iring_cap = torch.where(north, iring_n, iring_s)
    iphi_cap = torch.where(north, iphi_n, iphi_s)

    # cap: 1 - |z| = iring^2/(3 nside^2), computed as the small quantity
    one_minus_az = (iring_cap.to(dtype) ** 2) * (1.0 / (3.0 * nside * nside))
    z_cap = torch.where(north, 1.0 - one_minus_az, one_minus_az - 1.0)
    sth_cap = torch.sqrt(one_minus_az * (2.0 - one_minus_az))
    phi_cap = ((iphi_cap.to(dtype) - 0.5) * (math.pi / 2.0)
               / iring_cap.to(dtype))

    z_eq = (4.0 / 3.0) - 2.0 * iring_e.to(dtype) / (3.0 * nside)
    sth_eq = torch.sqrt(torch.clamp(1.0 - z_eq * z_eq, min=0.0))
    phi_eq = (iphi_e.to(dtype) - fodd) * (math.pi / (2.0 * nside))

    cap = north | south
    z = torch.where(cap, z_cap, z_eq)
    sth = torch.where(cap, sth_cap, sth_eq)
    phi = torch.where(cap, phi_cap, phi_eq)
    return sth * torch.cos(phi), sth * torch.sin(phi), z


# ----------------------------------------------------------------------------
# NEST <-> RING on device (int32; valid for order <= 13, npix < 2^31)
# ----------------------------------------------------------------------------

def _spread_bits32(v):
    """Bit i of v -> bit 2i (v < 2^15)."""
    x = v & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _compress_bits32(v):
    """Inverse of _spread_bits32: keep even bits, pack them."""
    x = v & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def _face_table(table, face):
    count("host_sync")       # the table's host -> device copy
    return torch.as_tensor(table, dtype=torch.int32,
                           device=face.device)[face.long()]


def ring2xyf_dev(pix, order: int):
    """RING pixel -> (x, y, face), int32 (core.ring2xyf; every
    intermediate < 2^31 for order <= 13)."""
    nside = 1 << order
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    pix = pix.to(torch.int32)

    north = pix < ncap
    south = pix >= npix - ncap

    iring_n = (1 + _isqrt_dev(1 + 2 * pix)) >> 1
    iphi_n = pix + 1 - 2 * iring_n * (iring_n - 1)
    face_n = (iphi_n - 1) // torch.clamp(iring_n, min=1)

    ip = pix - ncap
    tmp = ip >> (order + 2)
    iring_e = tmp + nside
    iphi_e = ip - tmp * 4 * nside + 1
    kshift_e = (iring_e + nside) & 1
    ire = iring_e - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = (iphi_e - ire // 2 + nside - 1) >> order
    ifp = (iphi_e - irm // 2 + nside - 1) >> order
    face_e = torch.where(ifp == ifm, ifp | 4,
                         torch.where(ifp < ifm, ifp, ifm + 8))

    ip_s = npix - pix
    iring_sl = (1 + _isqrt_dev(2 * ip_s - 1)) >> 1
    iphi_s = 4 * iring_sl + 1 - (ip_s - 2 * iring_sl * (iring_sl - 1))
    face_s = 8 + (iphi_s - 1) // torch.clamp(iring_sl, min=1)
    iring_s = 4 * nside - iring_sl

    iring = torch.where(north, iring_n, torch.where(south, iring_s, iring_e))
    iphi = torch.where(north, iphi_n, torch.where(south, iphi_s, iphi_e))
    kshift = torch.where(north | south, 0, kshift_e)
    nr = torch.where(north, iring_n,
                     torch.where(south, iring_sl, torch.full_like(pix, nside)))
    face = torch.where(north, face_n, torch.where(south, face_s, face_e))

    irt = iring - _face_table(hp.JRLL, face) * nside + 1
    ipt = 2 * iphi - _face_table(hp.JPLL, face) * nr - kshift - 1
    ipt = torch.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    return (ipt - irt) >> 1, (-ipt - irt) >> 1, face


def xyf2ring_dev(x, y, f, order: int):
    """(x, y, face) -> RING pixel, int32 (core.xyf2ring)."""
    nside = 1 << order
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    x, y, f = (v.to(torch.int32) for v in (x, y, f))

    jr = _face_table(hp.JRLL, f) * nside - x - y - 1
    north = jr < nside
    south = jr > 3 * nside

    nr = torch.where(north, jr, torch.where(south, 4 * nside - jr,
                                            torch.full_like(jr, nside)))
    n_before = torch.where(
        north, 2 * nr * (nr - 1),
        torch.where(south, npix - 2 * (nr + 1) * nr,
                    ncap + (jr - nside) * 4 * nside))
    kshift = torch.where(north | south, 0, (jr - nside) & 1)

    jp = (_face_table(hp.JPLL, f) * nr + x - y + 1 + kshift) >> 1
    jp = torch.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = torch.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def nest2ring_dev(pix, order: int):
    """NEST -> RING, int32 (order <= 13)."""
    pix = pix.to(torch.int32)
    p = pix & ((1 << (2 * order)) - 1)
    return xyf2ring_dev(_compress_bits32(p), _compress_bits32(p >> 1),
                        pix >> (2 * order), order)


def ring2nest_dev(pix, order: int):
    """RING -> NEST, int32 (order <= 13)."""
    x, y, f = ring2xyf_dev(pix, order)
    return (f << (2 * order)) + _spread_bits32(x) + (_spread_bits32(y) << 1)


def coarse_nest_from_ring(rpix, ray_order: int, map_order: int):
    """RING pixel at ray_order -> NEST pixel of its map_order parent (the
    lens-map NGP pixel, ray nest >> 2 (ray_order - map_order)).  Shifting
    (x, y) before the bit spread keeps every value < 2^15."""
    if not map_order <= ray_order <= 13:
        raise ValueError(f"need map_order <= ray_order <= 13, got "
                         f"{map_order}, {ray_order}")
    k = ray_order - map_order
    x, y, f = ring2xyf_dev(rpix, ray_order)
    return ((f << (2 * map_order)) + _spread_bits32(x >> k)
            + (_spread_bits32(y >> k) << 1))


class InterpTables:
    """The map grid of the bilinear interpolation (RING scheme, one
    order).  The ring geometry the taps need comes from _ring_geo_closed in
    closed form, so unlike the JAX package's class this one holds no ring
    tables."""

    def __init__(self, order: int):
        self.order = order
        self.nside = 1 << order
        self.npix = int(hp.order2npix(order))


def _ring_layout(ir, nside: int, npix: int):
    """Closed-form RingTable entries for 1-indexed ring numbers ir, in ir's
    integer dtype: (first pixel, pixels in ring, shifted flag)."""
    north = ir < nside
    south = ir > 3 * nside
    isouth = 4 * nside - ir
    nr = 4 * torch.where(north, ir, torch.where(south, isouth,
                                                torch.full_like(ir, nside)))
    ncap = 2 * nside * (nside - 1)
    sp = torch.where(
        north, 2 * ir * (ir - 1),
        torch.where(south, npix - 2 * isouth * (isouth + 1),
                    ncap + (ir - nside) * (4 * nside)))
    return sp, nr, north | south | (((ir + nside) & 1) == 0)


def _ring_geo_closed(ir, nside: int, npix: int, fdtype):
    """Closed-form per-ring geometry for 1-indexed ring numbers ir: (first
    pixel, pixels in ring, azimuth shift in pixels, theta) — the RingTable
    formulas as vector arithmetic instead of table gathers."""
    sp, nr, shifted = _ring_layout(ir, nside, npix)
    north = ir < nside
    south = ir > 3 * nside
    isouth = 4 * nside - ir
    shift = shifted.to(fdtype) * 0.5
    irf = ir.to(fdtype)
    isf = isouth.to(fdtype)
    # caps: theta = 2 asin(ir sqrt(1/(6 nside^2))) — the cancellation-free
    # form of arccos(1 - ir^2/(3 nside^2)), which loses ~3e-6 rad in f32
    # near the poles
    half = float(np.sqrt(1.0 / 6.0) / float(nside))
    th_n = 2.0 * torch.arcsin(torch.clamp(irf * half, 0.0, 1.0))
    th_s = math.pi - 2.0 * torch.arcsin(torch.clamp(isf * half, 0.0, 1.0))
    z_belt = 4.0 / 3.0 - 2.0 * irf / (3.0 * float(nside))
    th_e = torch.arccos(torch.clamp(z_belt, -1.0, 1.0))
    thr = torch.where(north, th_n, torch.where(south, th_s, th_e))
    return sp, nr, shift, thr


def ring_decode_pix(pk, nside: int, npix: int):
    """RING pixel -> (ring number 1..4nside-1, 0-based index in ring),
    exact integer arithmetic."""
    ncap = 2 * nside * (nside - 1)
    pk = pk.long()
    north = pk < ncap
    south = pk >= npix - ncap
    ir_n = (1 + _isqrt_dev(1 + 2 * pk)) >> 1
    i_n = pk - 2 * ir_n * (ir_n - 1)
    ip_s = npix - pk  # 1..ncap for south pixels
    ir_sl = (1 + _isqrt_dev(torch.clamp(2 * ip_s - 1, min=1))) >> 1
    i_s = 2 * ir_sl * (ir_sl + 1) - ip_s
    ip_e = pk - ncap
    tmp = torch.div(ip_e, 4 * nside, rounding_mode="floor")
    ir_e = tmp + nside
    i_e = ip_e - tmp * (4 * nside)
    ring = torch.where(north, ir_n, torch.where(south, 4 * nside - ir_sl, ir_e))
    idx = torch.where(north, i_n, torch.where(south, i_s, i_e))
    return ring, idx


def get_interpol_soa(tab: InterpTables, theta, phi):
    """4-pixel bilinear taps as separate [N] tensors.

    Returns ((p0..p3 int64 RING indices), (w0..w3 weights)).  Eager torch
    materializes every intermediate once, so the floor() knife edges that
    the JAX version pins with optimization barriers are decided once here.
    """
    nside = tab.nside
    z = torch.cos(theta)
    az = z.abs()
    ir_cap = (nside * torch.sqrt(torch.clamp(3.0 * (1.0 - az), min=0.0))).long()
    ir_eq = (nside * (2.0 - 1.5 * z)).long()
    ring_above = torch.where(az <= 2.0 / 3.0, ir_eq,
                             torch.where(z > 0, ir_cap,
                                         4 * nside - ir_cap - 1))
    ir1 = ring_above
    ir2 = ring_above + 1
    nrings = 4 * nside - 1

    def ring_interp(ir):
        sp, nr, shift, thr = _ring_geo_closed(
            torch.clamp(ir, 1, nrings), nside, tab.npix, theta.dtype)
        dphi = 2.0 * math.pi / nr.to(theta.dtype)
        tmp = phi / dphi - shift
        i1f = torch.floor(tmp)
        i1 = i1f.long()
        w = tmp - i1f
        i2 = i1 + 1
        i1 = torch.where(i1 < 0, i1 + nr, i1)
        i2 = torch.where(i2 >= nr, i2 - nr, i2)
        return sp + i1, sp + i2, w, thr

    p11, p12, w1, theta1 = ring_interp(ir1)
    p21, p22, w2, theta2 = ring_interp(ir2)

    north = ir1 == 0
    south = ir2 == 4 * nside

    wt = (theta - theta1) / torch.where(theta2 != theta1, theta2 - theta1,
                                        torch.ones_like(theta))
    wg0 = (1.0 - wt) * (1.0 - w1)
    wg1 = (1.0 - wt) * w1
    wg2 = wt * (1.0 - w2)
    wg3 = wt * w2

    # north pole fold (reference get_interpol ir1 == 0 branch)
    wtn = theta / theta2
    facn = (1.0 - wtn) * 0.25
    # south pole fold
    wts = (theta - theta1) / (math.pi - theta1)
    facs = wts * 0.25

    w0 = torch.where(north, facn,
                     torch.where(south, (1.0 - wts) * (1.0 - w1) + facs, wg0))
    w1_ = torch.where(north, facn,
                      torch.where(south, (1.0 - wts) * w1 + facs, wg1))
    w2_ = torch.where(north, wtn * (1.0 - w2) + facn,
                      torch.where(south, facs, wg2))
    w3_ = torch.where(north, wtn * w2 + facn, torch.where(south, facs, wg3))

    npix = tab.npix
    p0 = torch.where(north, (p21 + 2) % 4, p11)
    p1 = torch.where(north, (p22 + 2) % 4, p12)
    p2 = torch.where(south, ((p11 + 2) & 3) + npix - 4, p21)
    p3 = torch.where(south, ((p12 + 2) & 3) + npix - 4, p22)
    return (p0, p1, p2, p3), (w0, w1_, w2_, w3_)


def get_interpol(tab: InterpTables, theta, phi):
    """The 4-pixel bilinear taps stacked: (pix [..., 4] int64 RING indices,
    wgt [..., 4]), the form of calclens_tpu/healpix/jaxhp.py::get_interpol
    (the deposits' scatter-adds take one column per tap)."""
    pix, wgt = get_interpol_soa(tab, theta, phi)
    return torch.stack(pix, dim=-1), torch.stack(wgt, dim=-1)


def _ring_above(theta, nside: int):
    """The ring just north of colatitude theta (0 above the first ring),
    the reference get_interpol's ring_above."""
    z = torch.cos(theta)
    az = z.abs()
    ir_cap = (nside * torch.sqrt(torch.clamp(3.0 * (1.0 - az), min=0.0))
              ).to(torch.int32)
    ir_eq = (nside * (2.0 - 1.5 * z)).to(torch.int32)
    return torch.where(az <= 2.0 / 3.0, ir_eq,
                       torch.where(z > 0, ir_cap, 4 * nside - ir_cap - 1))


def triangles_ring(tab: InterpTables, pix):
    """Triangulation of the pixel-centre grid: RING pixels [...] -> the
    RING vertices of their triangles [..., 4, 3] int32, -1-padded (the
    reference's per-pixel ring2triangle, healpix_utils.c:1273-1423; equal to
    the host table healpix.core.build_triangles).  A pixel's ring and the
    ring above it come from ring_decode_pix and _ring_layout, int32 (exact
    through order 13); every modulus is Python's (the sign of the divisor),
    as in the host table and in JAX."""
    nside = tab.nside
    npix = tab.npix
    nrings = 4 * nside - 1
    i32 = torch.int32
    pix = pix.to(i32)
    ringnum, ip = (t.to(i32) for t in ring_decode_pix(pix, nside, npix))
    sp, Np, sh = _ring_layout(ringnum, nside, npix)
    sh = sh.to(i32)
    ringA = ringnum - 1
    spA, NpA, _ = _ring_layout(torch.clamp(ringA, 1, nrings), nside, npix)

    def mod(a, b):
        return torch.remainder(a, b)

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    right = mod(ip + 1, Np) + sp
    shape = pix.shape
    neg = torch.full(shape, -1, dtype=i32, device=pix.device)

    # north polar cap rings 2..nside
    rn = torch.clamp(ringnum, min=1)
    ib = mod(ip, rn)
    bnum = fdiv(ip, rn)
    interior = ib < ringnum - 1
    X_int = mod(ib + bnum * ringA, NpA) + spA
    X_cor = mod(ib + bnum * ringA - 1, NpA) + spA
    Xn = torch.where(interior, X_int, X_cor)
    X2n = mod(X_int - spA - 1, NpA) + spA

    # equatorial rings nside+1 .. 3*nside
    ibe = mod(ip, nside)
    bne = fdiv(ip, nside)
    above_nr = torch.where(ringA > nside, nside, ringA)
    Xe = mod(sh + ibe + bne * above_nr, NpA) + spA
    Xe2 = mod(Xe - spA - 1, NpA) + spA

    # south polar cap rings 3*nside+1 .. 4*nside-1
    nring = torch.clamp(4 * nside - ringnum, min=1)
    nringA = torch.clamp(4 * nside - ringA, min=1)
    ibs = mod(ip, nring)
    bns = fdiv(ip, nring)
    Xs = mod(sh + ibs + bns * nringA, NpA) + spA
    Xs2 = mod(Xs - spA - 1, NpA) + spA
    Xs3 = mod(Xs2 - spA - 1, NpA) + spA

    m_n = (ringnum >= 2) & (ringnum <= nside)
    m_e = (ringnum > nside) & (ringnum <= 3 * nside)
    m_s = ringnum > 3 * nside

    def tri_row(ok, b, c):
        return torch.stack([torch.where(ok, pix, neg),
                            torch.where(ok, b, neg),
                            torch.where(ok, c, neg)], dim=-1)

    tri = torch.stack([
        # slot 0: (pix, right, X)
        tri_row(m_n | m_e | m_s, right,
                torch.where(m_n, Xn, torch.where(m_e, Xe, Xs))),
        # slot 1: (pix, X, X2)
        tri_row((m_n & interior) | m_e | m_s,
                torch.where(m_n, X_int, torch.where(m_e, Xe, Xs)),
                torch.where(m_n, X2n, torch.where(m_e, Xe2, Xs2))),
        # slot 2: the south corner closer
        tri_row(m_s & (ibs == 0), Xs2, Xs3),
        neg[..., None].expand(shape + (3,)),
    ], dim=-2)  # [..., 4, 3]

    # ring-1 cap closers (pixels 0..3): exactly two triangles in all
    r1 = torch.stack([
        torch.where(pix == 0, 0, torch.where(pix == 2, 2, -1)),
        torch.where(pix == 0, 2, torch.where(pix == 2, 0, -1)),
        torch.where(pix == 0, 3, torch.where(pix == 2, 1, -1)),
    ], dim=-1).to(i32)
    r1tri = torch.cat([r1[..., None, :],
                       neg[..., None, None].expand(shape + (3, 3))], dim=-2)
    tri = torch.where((ringnum == 1)[..., None, None], r1tri, tri)

    # south pole closers in slot 3 of the last ring's two pixels
    last1 = pix == npix - 1
    last3 = pix == npix - 3
    close = torch.stack([
        torch.where(last1, npix - 1, torch.where(last3, npix - 3, -1)),
        torch.where(last1, npix - 3, torch.where(last3, npix - 2, -1)),
        torch.where(last1, npix - 4, torch.where(last3, npix - 1, -1)),
    ], dim=-1).to(i32)
    slot3 = torch.where((last1 | last3)[..., None], close, tri[..., 3, :])
    return torch.cat([tri[..., :3, :], slot3[..., None, :]], dim=-2)


def ring_window(tab: InterpTables, theta, phi, nring_w: int, nphi_w: int):
    """Candidate RING pixels in a (2 nring_w) x (2 nphi_w + 2) window
    around (theta, phi): rows are consecutive rings bracketing theta,
    columns the pixels nearest phi in each ring (the device analog of the
    galaxy search's candidate prep), from the closed-form ring layout.
    int32, floor and modulus with Python's semantics, as in JAX.

    Returns (pix [..., R, C] int32, valid [..., R, C] bool)."""
    nside = tab.nside
    nrings = 4 * nside - 1
    i32 = torch.int32
    dev = theta.device
    ring_above = _ring_above(theta, nside)
    drs = torch.arange(-nring_w + 1, nring_w + 1, dtype=i32, device=dev)
    ir = ring_above[..., None] + drs  # [..., R] 1-based
    rvalid = (ir >= 1) & (ir <= nrings)
    sp, nr, shifted = _ring_layout(torch.clamp(ir, 1, nrings), nside,
                                   tab.npix)
    shift = shifted.to(theta.dtype) * 0.5
    # a true division (a Python scalar over a tensor is reciprocal-times)
    dphi = torch.div(2.0 * math.pi, nr.to(theta.dtype))
    i0 = torch.floor(phi[..., None] / dphi - shift).to(i32) - nphi_w

    cols = torch.arange(2 * nphi_w + 2, dtype=i32, device=dev)
    ic = torch.remainder(i0[..., None] + cols, nr[..., None])  # [..., R, C]
    pixw = sp[..., None] + ic
    # duplicate columns when the window wraps a small polar ring
    cvalid = cols < nr[..., None]
    return pixw, rvalid[..., None] & cvalid
