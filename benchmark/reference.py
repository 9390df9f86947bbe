"""Plain reference of one SHT-only lens-plane step, for a sample of rays,
in float64 (the reference) or in a lower precision (the control).  It
imports nothing of the program: the HEALPix geometry, the band-limited
Poisson kernel, the interpolation with parallel transport and the ray
propagation are written here from their published definitions (Gorski et
al. 2005 and HEALPix's ang2pix_ring and get_interpol for the RING scheme;
Becker 2013, CALCLENS, for the plane step and rayprop).

One plane, as the program computes it:

    f_p   = densfact / pixarea * sum_{i in p} m_i - backdens   (NGP, RING)
    a_lm  = sum_p (4 pi / npix) f_p Y*_lm(p)                   (map2alm)
    phi   = sum_{l=1..L} -1 / (l (l + 1)) a_lm Y_lm             (Poisson)

By the addition theorem that is, exactly,

    phi(n) = sum_p q_p F(n . n_p),  q_p = pixarea f_p,
    F(x)   = -sum_{l=1..L} (2 l + 1) / (4 pi l (l + 1)) P_l(x),

a sum over the pixels (here `pixel_sum`, with F and its x derivatives
tabulated in the chord u = sqrt(2 (1 -+ x)) and read by cubic Hermite
interpolation).  On the full sky the background, -backdens on every pixel,
enters as the quadrature of a constant map: the constant's m = 0
harmonics from every ring, summed over l directly (`legendre_pass`), but
for the first rings of each polar cap, whose pixels enter the pixel sum
(they alias the constant onto m = 4 i k, the rest do not to 1e-24).  On a
cut sky (a ra/dec box) only the pixels within the box widened by a buffer
carry density and background; the rest are zero, and every live pixel
enters the pixel sum.  No transform of the program's kind (ring FFTs,
Legendre sweeps) is used.

The particles' NGP pixels are found in the precision the configuration
states (float32: HEALPix ang2pix_ring on the float32 positions), since a
particle within rounding of a pixel edge lands in another pixel in float64.

The six fields at each tap pixel (phi, its gradient and its covariant
Hessian on the (theta, phi) unit basis) are interpolated to the ray by the
4-pixel bilinear weights with parallel transport, and the ray is
propagated to the next plane (rayprop: deflection, geodesic chord, the
lensing-matrix recursion).  The control runs every step on the plane's
data in its dtype (bfloat16): the pixel assignment, the mass sums, the
pixel sum, the interpolation and the propagation; only the tables (the
kernel's Hermite pieces, the background's quadrature, the pixel centres)
are built in float64 and stored in that dtype.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

RHO_CRIT = 2.77519737e11  # h^2 Msun / Mpc^3
CSOL = 299792.458         # km / s
DH = 2997.92458           # c / H0 in Mpc/h


# ----------------------------------------------------------------------------
# cosmology and the plane's scalars
# ----------------------------------------------------------------------------

def scale_factor(chi, omega_m):
    """a(chi) in flat LCDM (h = 1 units), by bisection on the comoving
    distance integral, each integral by 400-point Gauss-Legendre."""
    xg, wg = np.polynomial.legendre.leggauss(400)

    def comv(a):
        s = 0.5 * (1.0 - a) * xg + 0.5 * (1.0 + a)
        f = 1.0 / np.sqrt(omega_m * s + (1.0 - omega_m) * s**4)
        return DH * 0.5 * (1.0 - a) * np.dot(wg, f)

    lo, hi = 1e-3, 1.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if comv(mid) > chi:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def plane_scalars(plane, n_planes, max_dist, omega_m):
    """(densfact, backdens, wp, wpm1, wpm2) of a plane (CALCLENS
    set_plane_params) for the planes of a lightcone of n_planes equal
    shells out to max_dist."""
    binL = max_dist / n_planes
    rad = plane * binL + binL / 2.0
    wpm2 = 0.0 if plane < 1 else (plane - 1.0) * binL + binL / 2.0
    wp = max_dist if plane + 1 == n_planes else (plane + 1.0) * binL + binL / 2.0
    vol = ((rad + binL / 2.0) ** 3 - (rad - binL / 2.0) ** 3) / 3.0
    zw = 1.0 / scale_factor(rad, omega_m) - 1.0
    lens = 3.0 * 100.0 * 100.0 / CSOL / CSOL * omega_m * rad * (1.0 + zw) * binL
    return lens / (vol * RHO_CRIT * omega_m), lens, wp, rad, wpm2


# ----------------------------------------------------------------------------
# HEALPix RING geometry
# ----------------------------------------------------------------------------

class Healpix:
    """The RING scheme at one order, on a device, in float64."""

    def __init__(self, order, device):
        self.order = order
        self.nside = ns = 1 << order
        self.npix = 12 * ns * ns
        self.ncap = 2 * ns * (ns - 1)
        self.nrings = 4 * ns - 1
        self.device = torch.device(device)

    def ring_info(self, i):
        """Ring index i (1 .. 4 nside - 1, int64) -> (first pixel, pixels,
        z, sin theta, azimuth offset in pixels)."""
        ns, f64 = self.nside, torch.float64
        north, south = i < ns, i > 3 * ns
        ic = torch.where(south, 4 * ns - i, i)  # the cap ring's index from its pole
        cap = north | south
        nr = torch.where(cap, 4 * ic, torch.full_like(i, 4 * ns))
        start = torch.where(
            north, 2 * ic * (ic - 1),
            torch.where(south, self.npix - 2 * ic * (ic + 1),
                        self.ncap + (i - ns) * 4 * ns))
        icf = ic.to(f64)
        one_m_z = icf * icf / (3.0 * ns * ns)        # caps: 1 - |z|, exact
        zcap = 1.0 - one_m_z
        zbelt = (2 * ns - i).to(f64) * (2.0 / (3.0 * ns))
        z = torch.where(north, zcap, torch.where(south, -zcap, zbelt))
        sth = torch.where(cap, torch.sqrt(one_m_z * (2.0 - one_m_z)),
                          torch.sqrt((1.0 - zbelt) * (1.0 + zbelt)))
        off = torch.where(cap | ((i + ns) % 2 == 0), 0.5, 0.0).to(f64)
        return start, nr, z, sth, off

    def pix2ring(self, pix):
        """RING pixel -> (ring index, index in the ring)."""
        ns = self.nside
        north = pix < self.ncap
        south = pix >= self.npix - self.ncap

        def isqrt(v):
            r = torch.floor(torch.sqrt(v.to(torch.float64))).to(torch.int64)
            r = torch.where(r * r > v, r - 1, r)
            return torch.where((r + 1) * (r + 1) <= v, r + 1, r)

        inorth = (1 + isqrt(1 + 2 * pix)) // 2
        ip = self.npix - pix
        isouth = (1 + isqrt(torch.clamp(2 * ip - 1, min=0))) // 2
        ibelt = (pix - self.ncap) // (4 * ns) + ns
        i = torch.where(north, inorth,
                        torch.where(south, 4 * ns - isouth, ibelt))
        start = self.ring_info(i)[0]
        return i, pix - start

    def pix2vec(self, pix):
        """RING pixel -> unit vector [n, 3] of its centre."""
        i, j = self.pix2ring(pix)
        _, nr, z, sth, off = self.ring_info(i)
        ph = (j.to(torch.float64) + off) * (2.0 * math.pi) / nr.to(torch.float64)
        return torch.stack([sth * torch.cos(ph), sth * torch.sin(ph), z], 1)

    def ang2pix(self, theta, phi):
        """(theta, phi) -> RING pixel, HEALPix ang2pix_ring step by step
        (z = cos theta, tt = (phi mod 2 pi) / (pi / 2)), in the dtype of
        theta and phi; clamped to the map in a precision too low to stay on
        it."""
        ns = self.nside
        z = torch.cos(theta)
        za = z.abs()
        tt = torch.remainder(phi, 2.0 * math.pi) * (2.0 / math.pi)
        # equatorial belt
        t1 = ns * (0.5 + tt)
        t2 = ns * z * 0.75
        jp = torch.floor(t1 - t2).to(torch.int64)
        jm = torch.floor(t1 + t2).to(torch.int64)
        ir = ns + 1 + jp - jm
        kshift = 1 - (ir & 1)
        ip = torch.remainder(torch.div(jp + jm - ns + kshift + 1, 2,
                                       rounding_mode="floor"), 4 * ns)
        belt = self.ncap + (ir - 1) * 4 * ns + ip
        # polar caps
        tp = tt - torch.floor(tt)
        tmp = ns * torch.sqrt(torch.clamp(3.0 * (1.0 - za), min=0.0))
        jp = torch.floor(tp * tmp).to(torch.int64)
        jm = torch.floor((1.0 - tp) * tmp).to(torch.int64)
        irc = (jp + jm + 1).clamp(min=1)
        ipc = torch.remainder(torch.floor(tt * irc).to(torch.int64), 4 * irc)
        capn = 2 * irc * (irc - 1) + ipc
        caps = self.npix - 2 * irc * (irc + 1) + ipc
        pix = torch.where(za <= 2.0 / 3.0, belt,
                          torch.where(z > 0, capn, caps))
        return pix.clamp(0, self.npix - 1)

    def vec2pix(self, v):
        """Vectors [n, 3] (any length) -> RING pixel, in v's dtype: theta =
        arccos(z / |v|), phi = atan2(y, x) in [0, 2 pi), then ang2pix."""
        r = torch.linalg.vector_norm(v, dim=1)
        theta = torch.arccos(torch.clamp(v[:, 2] / r, -1.0, 1.0))
        phi = torch.atan2(v[:, 1], v[:, 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        return self.ang2pix(theta, phi)

    def box_runs(self, box):
        """The pixels whose centres lie in box = (min ra, max ra, min dec,
        max dec) in degrees (0 <= min ra < max ra <= 360), as runs: (first
        pixel [R], count [R]) of each ring that holds any, in ring order, so
        that the runs' concatenation is the box's pixels in RING order."""
        lo_ra, hi_ra, lo_dec, hi_dec = box
        i = torch.arange(1, self.nrings + 1, device=self.device)
        start, nr, z, sth, off = self.ring_info(i)
        dec = 90.0 - torch.rad2deg(torch.atan2(sth, z))
        nrf = nr.to(torch.float64)
        j0 = torch.ceil(lo_ra / 360.0 * nrf - off).clamp(min=0.0)
        j1 = torch.minimum(torch.floor(hi_ra / 360.0 * nrf - off), nrf - 1.0)
        n = (j1 - j0 + 1.0).clamp(min=0.0).to(torch.int64)
        n = torch.where((dec >= lo_dec) & (dec <= hi_dec), n, 0)
        keep = n > 0
        return start[keep] + j0[keep].to(torch.int64), n[keep]

    def box_pixels(self, box):
        """Every pixel of the box (box_runs), in RING order [n]."""
        first, n = self.box_runs(box)
        base = torch.cumsum(n, 0) - n
        k = torch.arange(int(n.sum()), device=self.device)
        run = torch.repeat_interleave(torch.arange(len(n), device=self.device), n)
        return first[run] + (k - base[run])

    def box_pixel_at(self, box, cols):
        """The pixels at positions cols of the box's RING-ordered list, and
        the list's length."""
        first, n = self.box_runs(box)
        end = torch.cumsum(n, 0)
        run = torch.searchsorted(end, cols, right=True)
        if len(cols) and int(cols.max()) >= int(end[-1]):
            raise IndexError(f"column {int(cols.max())} of a box of "
                             f"{int(end[-1])} pixels")
        return first[run] + (cols - (end[run] - n[run])), int(end[-1])

    def in_box(self, pix, box):
        """Whether each pixel's centre lies in box (as box_runs)."""
        lo_ra, hi_ra, lo_dec, hi_dec = box
        v = self.pix2vec(pix)
        dec = 90.0 - torch.rad2deg(torch.atan2(
            torch.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2), v[:, 2]))
        ra = torch.rad2deg(torch.remainder(torch.atan2(v[:, 1], v[:, 0]),
                                           2.0 * math.pi))
        return (ra >= lo_ra) & (ra <= hi_ra) & (dec >= lo_dec) & (dec <= hi_dec)

    def ring_above(self, z):
        ns = self.nside
        za = z.abs()
        belt = torch.floor(ns * (2.0 - 1.5 * z)).to(torch.int64)
        cap = torch.floor(ns * torch.sqrt(3.0 * (1.0 - za))).to(torch.int64)
        return torch.where(za <= 2.0 / 3.0, belt,
                           torch.where(z > 0, cap, 4 * ns - cap - 1))

    def interpol(self, theta, phi):
        """HEALPix get_interpol (RING): the 4 pixels [n, 4] and bilinear
        weights [n, 4] of each direction."""
        z = torch.cos(theta)
        ir1 = self.ring_above(z)
        ir2 = ir1 + 1
        two_pi = 2.0 * math.pi

        def pair(ir):
            irc = torch.clamp(ir, 1, self.nrings)
            start, nr, zr, sth, off = self.ring_info(irc)
            dphi = two_pi / nr.to(torch.float64)
            tmp = phi / dphi - off
            i1 = torch.floor(tmp).to(torch.int64)
            w1 = (phi - (i1.to(torch.float64) + off) * dphi) / dphi
            i2 = i1 + 1
            i1 = torch.where(i1 < 0, i1 + nr, i1)
            i2 = torch.where(i2 >= nr, i2 - nr, i2)
            th = torch.atan2(sth, zr)
            return start + i1, start + i2, 1.0 - w1, w1, th

        p0, p1, w0, w1, th1 = pair(ir1)
        p2, p3, w2, w3, th2 = pair(ir2)
        north = ir1 == 0
        south = ir2 == 4 * self.nside
        mid = ~(north | south)
        # interior
        wt = (theta - th1) / torch.where(mid, th2 - th1, 1.0)
        # north pole fold: ring 1's pair and its opposite pair
        wtn = theta / th2
        facn = (1.0 - wtn) * 0.25
        # south pole fold
        wts = (theta - th1) / (math.pi - th1)
        facs = wts * 0.25
        W0 = torch.where(north, facn, torch.where(south, w0 * (1 - wts) + facs, w0 * (1 - wt)))
        W1 = torch.where(north, facn, torch.where(south, w1 * (1 - wts) + facs, w1 * (1 - wt)))
        W2 = torch.where(north, w2 * wtn + facn, torch.where(south, facs, w2 * wt))
        W3 = torch.where(north, w3 * wtn + facn, torch.where(south, facs, w3 * wt))
        P0 = torch.where(north, (p2 + 2) & 3, p0)
        P1 = torch.where(north, (p3 + 2) & 3, p1)
        P2 = torch.where(south, ((p0 + 2) & 3) + self.npix - 4, p2)
        P3 = torch.where(south, ((p1 + 2) & 3) + self.npix - 4, p3)
        return (torch.stack([P0, P1, P2, P3], 1),
                torch.stack([W0, W1, W2, W3], 1))


def unit_basis(v):
    """(theta_hat, phi_hat) [n, 3] each at unit vectors v [n, 3]."""
    x, y, z = v.unbind(1)
    rho = torch.sqrt(x * x + y * y).clamp_min(1e-300)
    th = torch.stack([z * x / rho, z * y / rho, -rho], 1)
    ph = torch.stack([-y / rho, x / rho, torch.zeros_like(x)], 1)
    return th, ph


# ----------------------------------------------------------------------------
# one pass over l: the band-limited kernel F(x) and the background's fields
# ----------------------------------------------------------------------------

def c_l(l):
    """The kernel's Legendre coefficient -(2l+1) / (4 pi l (l+1))."""
    return -(2.0 * l + 1.0) / (4.0 * math.pi * l * (l + 1.0))


class Kernel:
    """F_k(x) = d^k/dx^k sum_{l=1..L} c_l P_l(x), k = 0..2, as cubic Hermite
    pieces on u = sqrt(2 (1 - x)) for x >= 0 and u = sqrt(2 (1 + x)) for
    x < 0 (both polynomials in u^2), node spacing h = 1 / (H_L L), from the
    node values of F_0..F_3 and the slopes dF_k/du = -+ u F_{k+1}: good to
    ~(h L)^4 / 384 (1e-9 at H_L = 40) of the local amplitude.  The pieces
    are kept as Horner coefficients [12, 2 (n - 1)]: three functions times
    four coefficients, one column per interval (the + half's, then the -
    half's), so each is gathered into a contiguous array."""

    H_L = 40.0

    def __init__(self, lmax, F, n):
        self.lmax, self.n = lmax, n
        self.h = h = 1.0 / (self.H_L * lmax)
        rows = []
        for half, sg in ((0, -h), (1, h)):
            sl = slice(half * n, (half + 1) * n)
            u = torch.arange(n, dtype=F.dtype, device=F.device) * h
            for k in range(3):
                f = F[k][sl]
                m = sg * u * F[k + 1][sl]         # h dF_k/du at the nodes
                f0, f1, m0, m1 = f[:-1], f[1:], m[:-1], m[1:]
                rows += [f0, m0, 3 * (f1 - f0) - 2 * m0 - m1,
                         2 * (f0 - f1) + m0 + m1]
        per_half = len(rows) // 2
        self.coef = torch.cat([torch.stack(rows[:per_half]),
                               torch.stack(rows[per_half:])], 1)

    @classmethod
    def nodes(cls, lmax, device):
        h = 1.0 / (cls.H_L * lmax)
        n = int(math.ceil(math.sqrt(2.0) / h)) + 3
        u = torch.arange(n, dtype=torch.float64, device=device) * h
        return n, torch.cat([1.0 - 0.5 * u * u, -1.0 + 0.5 * u * u])

    def __call__(self, x):
        """F_0, F_1, F_2 at x (any shape)."""
        t = x.abs().mul_(-2.0).add_(2.0).clamp_(min=0.0).sqrt_()
        t.mul_(1.0 / self.h)
        # the interval's index in float64, whatever x's dtype: a lower
        # precision rounds the chord t, not the table's addresses
        td = t.double()
        i = torch.floor(td).clamp_(max=self.n - 2)
        s = (td - i).to(x.dtype)
        idx = torch.where(x < 0, i + (self.n - 1), i).to(torch.int64)
        out = []
        for k in range(3):
            c = [self.coef[4 * k + j][idx] for j in range(4)]
            f = torch.addcmul(c[2], c[3], s)
            f = torch.addcmul(c[1], f, s)
            out.append(f.mul_(s).add_(c[0]))
        return out

    def to(self, dtype):
        """The same pieces, stored in dtype."""
        k = copy.copy(self)
        k.coef = self.coef.to(dtype)
        return k


# cap rings (from each pole) whose pixels the background sums directly: a
# ring of 4 i pixels aliases the constant map onto m = 4 i k, and for
# l <= lmax = 3 nside - 1 those harmonics sit where l sin(theta_i) / m <= 0.61,
# damped as e^(-0.29 m) <= e^(-1.16 i): below 1e-24 beyond i = 48
POLAR_RINGS = 48


def polar_pixels(hp):
    """The RING pixels of the first POLAR_RINGS rings of each cap."""
    ns = hp.nside
    ic = min(ns - 1, POLAR_RINGS)
    north = torch.arange(2 * ic * (ic + 1), device=hp.device)
    return torch.cat([north, hp.npix - 1 - north])


def legendre_pass(hp, lmax, taps):
    """One pass over l = 1..lmax, all points at once.  Returns (Kernel,
    background [6, T]): the kernel's tables, and the fields at taps [T, 3]
    of the m = 0 quadrature, weighted by pixarea, of a map equal to 1 on
    every ring but the polar_pixels' (whose every harmonic tap_fields sums
    pixel by pixel): the part of a constant that the Poisson filter keeps
    (l > 0).  Its other harmonics (m = 4 i k of a cap ring of 4 i pixels)
    are below 1e-24 of the ring's share (POLAR_RINGS)."""
    dev = taps.device
    f64 = torch.float64
    L = int(lmax)
    pixarea = 4.0 * math.pi / hp.npix
    n, xk = Kernel.nodes(L, dev)
    ic = min(hp.nside - 1, POLAR_RINGS)
    rings = torch.arange(ic + 1, hp.nrings - ic + 1, device=dev)
    _, nr, zr, _, _ = hp.ring_info(rings)
    nrf = nr.to(f64)
    T = len(taps)
    zt = taps[:, 2].clamp(-1.0, 1.0)
    st = torch.sqrt(taps[:, 0] ** 2 + taps[:, 1] ** 2)
    # P_l and its first three x derivatives [4, points] at the kernel's
    # nodes, the rings' z and the taps' z; D the current degree, Dm the one
    # below
    X = torch.cat([xk, zr, zt])
    K, R = len(xk), len(zr)
    D = torch.zeros((4, len(X)), dtype=f64, device=dev)
    Dm = torch.zeros_like(D)
    D[0] = X
    D[1] = 1.0
    Dm[0] = 1.0
    F = torch.zeros((4, K), dtype=f64, device=dev)
    g = torch.zeros((3, T), dtype=f64, device=dev)
    for l in range(1, L + 1):
        c = c_l(l)
        F.add_(D[:, :K], alpha=c)
        B = torch.dot(nrf, D[0, K:K + R])
        g.addcmul_(D[:3, K + R:], B, value=pixarea * c)
        if l == L:
            break
        # D_k,l+1 = D_k,l-1 + (2l+1) D_k-1,l; P_l+1 by Bonnet
        Dm[1:].add_(D[:3], alpha=2 * l + 1)
        Dm[0].mul_(-l / (l + 1)).addcmul_(D[0], X, value=(2 * l + 1) / (l + 1))
        D, Dm = Dm, D
    kernel = Kernel(L, F, n)
    # the fields of g(z) on the unit basis (t_theta = -sin theta)
    out = torch.zeros((6, T), dtype=f64, device=dev)
    out[0] = g[0]
    out[1] = -st * g[1]
    out[3] = st * st * g[2] - zt * g[1]
    out[5] = -zt * g[1]
    return kernel, out


# ----------------------------------------------------------------------------
# the six fields at tap pixels
# ----------------------------------------------------------------------------

def pixel_sum(kernel, taps, pix_vec, q, tap_chunk=256, pix_chunk=1 << 16):
    """Fields [6, T] at unit vectors taps [T, 3] of the point sources q [P]
    at unit vectors pix_vec [P, 3]: phi = sum q F(x), grad = sum q F'(x) t,
    Hess = sum q (F''(x) t t - F'(x) x 1), t the source's tangent
    components on the tap's (theta_hat, phi_hat).  Computed in taps'
    dtype, as are pix_vec, q and the kernel's pieces."""
    th, ph = unit_basis(taps)
    out = torch.zeros((6, len(taps)), dtype=taps.dtype, device=taps.device)
    for a in range(0, len(taps), tap_chunk):
        b = min(len(taps), a + tap_chunk)
        nt, et, ep = taps[a:b], th[a:b], ph[a:b]
        acc = out[:, a:b]
        for c in range(0, len(q), pix_chunk):
            d = min(len(q), c + pix_chunk)
            v, w = pix_vec[c:d].T, q[c:d]
            x = torch.clamp(nt @ v, -1.0, 1.0)
            F0, F1, F2 = kernel(x)
            tt = et @ v
            tp = ep @ v
            xF1 = (F1 * x) @ w
            acc[0] += F0 @ w
            acc[1] += (F1 * tt) @ w
            acc[2] += (F1 * tp) @ w
            F2t = F2 * tt
            acc[3] += (F2t * tt) @ w - xF1
            acc[4] += (F2t * tp) @ w
            F2 *= tp
            acc[5] += (F2 * tp) @ w - xF1
    return out


def tap_fields(hp, lmax, tap_pix, pos, mass, densfact, backdens, live=None,
               dtype=torch.float64, pix_dtype=None):
    """The six field maps of the plane at the RING pixels tap_pix [T]
    ([6, T] in dtype): the particles pos [N, 3], mass [N] deposited NGP,
    their pixels found in pix_dtype (dtype if None), the Poisson solve
    band-limited at lmax.  live: None for the full sky, else the box (as
    Healpix.box_runs) outside which the map is zero."""
    dev = tap_pix.device
    pix = hp.vec2pix(pos.to(dev, pix_dtype or dtype))
    occ, inv = torch.unique(pix, return_inverse=True)
    del pix
    msum = torch.zeros(len(occ), dtype=dtype, device=dev)
    msum.index_add_(0, inv, mass.to(dev, dtype))
    del inv
    taps = hp.pix2vec(tap_pix)
    kernel, bg = legendre_pass(hp, lmax, taps)
    pixarea = 4.0 * math.pi / hp.npix
    if live is None:
        back = polar_pixels(hp)
    else:
        keep = hp.in_box(occ, live)
        occ, msum = occ[keep], msum[keep]
        back = hp.box_pixels(live)
    src = torch.cat([occ, back])
    q = torch.cat([msum * densfact,
                   torch.full((len(back),), -backdens * pixarea, dtype=dtype,
                              device=dev)])
    out = pixel_sum(kernel.to(dtype), taps.to(dtype),
                    hp.pix2vec(src).to(dtype), q)
    if live is None:
        out -= backdens * bg.to(dtype)
    return out


# ----------------------------------------------------------------------------
# interpolation with parallel transport, and propagation
# ----------------------------------------------------------------------------

def transport_angle(v, r):
    """(cos psi, sin psi) [n] of the angle of v's phi_hat, carried to r by
    the rotation about v x r, on r's (phi_hat, theta_hat) basis."""
    axis = torch.cross(v, r, dim=1)
    sa = torch.linalg.vector_norm(axis, dim=1)
    ca = (v * r).sum(1)
    same = sa == 0
    a = axis / torch.where(same, 1.0, sa)[:, None]
    _, pv = unit_basis(v)
    q = (pv * ca[:, None] + a * (a * pv).sum(1, keepdim=True) * (1 - ca)[:, None]
         + torch.cross(a, pv, dim=1) * sa[:, None])
    tr, pr = unit_basis(r)
    c = (q * pr).sum(1)
    s = (q * tr).sum(1)
    return torch.where(same, 1.0, c), torch.where(same, 0.0, s)


def rot_tensor(c, s, t00, t01, t10, t11):
    """R^T T R with R = [[c, -s], [s, c]]."""
    a = t00 * c + t01 * s
    b = -t00 * s + t01 * c
    d = t10 * c + t11 * s
    e = -t10 * s + t11 * c
    return c * a + s * d, c * b + s * e, -s * a + c * d, -s * b + c * e


def interpolate(hp, state, fields_at):
    """Fields at each ray (pot, alpha, U) [7, n] = [pot, a0, a1, U00, U01,
    U10, U11] from the tap fields: fields_at(tap_pix [n, 4]) -> [6, n, 4]."""
    n = state[0:3].T
    h = n / torch.linalg.vector_norm(n, dim=1, keepdim=True)
    theta = torch.arccos(h[:, 2].clamp(-1.0, 1.0))
    phi = torch.remainder(torch.atan2(h[:, 1], h[:, 0]), 2.0 * math.pi)
    pix, w = hp.interpol(theta.double(), phi.double())
    f = fields_at(pix)                                    # [6, n, 4]
    dt = state.dtype
    out = torch.zeros((7, n.shape[0]), dtype=dt, device=state.device)
    for k in range(4):
        tv = hp.pix2vec(pix[:, k]).to(dt)
        c, s = transport_angle(tv, h)
        wk = w[:, k].to(dt)
        fk = f[:, :, k].to(dt)
        gt, gp = fk[1], fk[2]
        out[0] += fk[0] * wk
        out[1] += -(gt * c + gp * s) * wk          # alpha = -grad
        out[2] += -(-gt * s + gp * c) * wk
        t = rot_tensor(c, s, fk[3], fk[4], fk[4], fk[5])
        for j in range(4):
            out[3 + j] += t[j] * wk
    return out


def propagate(state, fld, wp, wpm1, wpm2):
    """rayprop (not Born) of the packed state [21, n] with this plane's
    fields fld [7, n] (pot, alpha, U): the new state [21, n]."""
    n, b = state[0:3].T, state[3:6].T
    A = state[6:10].T.reshape(-1, 2, 2)
    P = state[10:14].T.reshape(-1, 2, 2)
    pot, al = fld[0], fld[1:3].T
    U = fld[3:7].T.reshape(-1, 2, 2)
    f = wpm1 * (wp - wpm2) / (wp * (wpm1 - wpm2))
    g = (wp - wpm1) / wp
    N = (1.0 - f) * P + f * A - g * (U @ A)
    h = n / torch.linalg.vector_norm(n, dim=1, keepdim=True)
    th, ph = unit_basis(h)
    amag = torch.linalg.vector_norm(al, dim=1)
    av = al[:, :1] * th + al[:, 1:] * ph
    ax = torch.cross(n, av, dim=1)
    an = torch.linalg.vector_norm(ax, dim=1, keepdim=True)
    ax = ax / torch.where(an > 0, an, 1.0)
    ca, sa = torch.cos(amag)[:, None], torch.sin(amag)[:, None]
    bent = (amag > 0)[:, None]
    bb = torch.where(bent, b * ca + ax * (ax * b).sum(1, keepdim=True) * (1 - ca)
                     + torch.cross(ax, b, dim=1) * sa, b)
    qb = 2.0 * (n * bb).sum(1)
    qc = wpm1 * wpm1 - wp * wp
    disc = torch.sqrt(torch.clamp(qb * qb - 4.0 * qc, min=0.0))
    q = -0.5 * (qb + torch.sign(qb) * disc)
    lam1 = qc / torch.where(q != 0, q, 1.0)
    lam = torch.where(lam1 < 0, q, lam1)
    m = n + bb * lam[:, None]
    mr = torch.linalg.vector_norm(m, dim=1, keepdim=True)
    c, s = transport_angle(h, m / mr)
    Pn = rot_tensor(c, s, A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1])
    An = rot_tensor(c, s, N[:, 0, 0], N[:, 0, 1], N[:, 1, 0], N[:, 1, 1])
    rows = [*(m * (wp / mr)).T, *bb.T, *An, *Pn, fld[1], fld[2], *fld[3:7],
            pot]
    return torch.stack(rows)


def initial_state(hp_ray, pix, radius, dtype=torch.float64):
    """The rays' state before the first plane [21, n]: at radius on the
    rayOrder pixel centres, beta the unit vector, A = Aprev = 1."""
    v = hp_ray.pix2vec(pix).to(dtype)
    out = torch.zeros((21, len(pix)), dtype=dtype, device=v.device)
    out[0:3] = (v * radius).T
    out[3:6] = v.T
    out[6] = out[9] = out[10] = out[13] = 1.0
    return out


def plane_step(hp, lmax, state, pos, mass, scal, live=None,
               dtype=torch.float64, pix_dtype=None):
    """The sampled rays' state after one plane [21, n], from their state
    before it [21, n] and the plane's particles; scal = plane_scalars(...),
    live as tap_fields'.  dtype float64, with pix_dtype the configuration's
    precision, is the reference; bfloat16 the control."""
    densfact, backdens, wp, wpm1, wpm2 = scal

    def fields_at(pix):
        flat = pix.reshape(-1)
        f = tap_fields(hp, lmax, flat, pos, mass, densfact, backdens, live,
                       dtype, pix_dtype)
        return f.reshape(6, *pix.shape)

    st = state.to(dtype)
    fld = interpolate(hp, st, fields_at)
    return propagate(st, fld, wp, wpm1, wpm2)
