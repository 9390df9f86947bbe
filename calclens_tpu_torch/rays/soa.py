"""Packed ray state and the per-plane ray side: field interpolation with
parallel transport (shtpoissonsolve.c:1122-1204) and geodesic propagation
(rayprop.c:18-189), componentwise on [N] rows.

Port of calclens_tpu/rays/soa.py on the global-gather path.  The rays live
packed as one [21, N] buffer.  Row layout: 0-2 n, 3-5 beta, 6-9 A (00, 01,
10, 11), 10-13 Aprev, 14-15 alpha, 16-19 U, 20 phi.
"""

from __future__ import annotations

import math

import torch

from ..healpix import torchhp

NROWS = 21


def pack(rays):
    """Rays view (torch tensors) -> packed [21, N]."""
    rows = [rays.n[:, 0], rays.n[:, 1], rays.n[:, 2],
            rays.beta[:, 0], rays.beta[:, 1], rays.beta[:, 2],
            rays.A[:, 0, 0], rays.A[:, 0, 1], rays.A[:, 1, 0], rays.A[:, 1, 1],
            rays.Aprev[:, 0, 0], rays.Aprev[:, 0, 1],
            rays.Aprev[:, 1, 0], rays.Aprev[:, 1, 1],
            rays.alpha[:, 0], rays.alpha[:, 1],
            rays.U[:, 0, 0], rays.U[:, 0, 1], rays.U[:, 1, 0], rays.U[:, 1, 1],
            rays.phi]
    return torch.stack(rows, dim=0)


def unpack(packed):
    """Packed [21, N] -> Rays view (same library as the input)."""
    from .propagate import Rays

    r = packed

    def mat(i):
        return r[i: i + 4].T.reshape(-1, 2, 2)

    return Rays(n=r[0:3].T, beta=r[3:6].T, A=mat(6), Aprev=mat(10),
                alpha=r[14:16].T, U=mat(16), phi=r[20])


# ----------------------------------------------------------------------------
# componentwise geometry helpers (rot_paratrans.c, branch-free)
# ----------------------------------------------------------------------------

def _transport_psi(vx, vy, vz, rx, ry, rz):
    """cos/sin of the parallel-transport basis angle from unit v to unit r
    (rot_paratrans.c:101-273), componentwise."""
    ax = vy * rz - vz * ry
    ay = vz * rx - vx * rz
    az = vx * ry - vy * rx
    cosang = vx * rx + vy * ry + vz * rz
    sinang = torch.sqrt(ax * ax + ay * ay + az * az)
    safe = sinang > 0.0
    inv = 1.0 / torch.where(safe, sinang, 1.0)
    ax = torch.where(safe, ax * inv, 1.0)
    ay = torch.where(safe, ay * inv, 0.0)
    az = torch.where(safe, az * inv, 0.0)

    # rotate e_phi(v) = (-vy, vx, 0) about the axis by (cosang, sinang)
    px, py = -vy, vx
    adotp = ax * px + ay * py
    cx = -az * py
    cy = az * px
    cz = ax * py - ay * px
    one_m_c = 1.0 - cosang
    qx = px * cosang + ax * adotp * one_m_c + cx * sinang
    qy = py * cosang + ay * adotp * one_m_c + cy * sinang
    qz = az * adotp * one_m_c + cz * sinang

    # r's tangent basis (unnormalized; normalization via inv2)
    ephx, ephy = -ry, rx
    etx = rz * rx
    ety = rz * ry
    etz = -(rx * rx + ry * ry)

    norm = torch.sqrt((1.0 - rz) * (1.0 + rz) * (1.0 - vz) * (1.0 + vz))
    inv2 = 1.0 / torch.where(norm > 0.0, norm, 1.0)
    sinpsi = (qx * etx + qy * ety + qz * etz) * inv2
    cospsi = (qx * ephx + qy * ephy) * inv2
    same = sinang == 0.0
    return torch.where(same, 1.0, cospsi), torch.where(same, 0.0, sinpsi)


def _rot_tensor(c, s, t00, t01, t10, t11):
    """R^T T R with R = [[c, -s], [s, c]], componentwise."""
    a = t00 * c + t01 * s
    b = -t00 * s + t01 * c
    d = t10 * c + t11 * s
    e = -t10 * s + t11 * c
    return (c * a + s * d, c * b + s * e,
            -s * a + c * d, -s * b + c * e)


def _tangent_basis(nx, ny, nz):
    """Orthonormal (theta_hat, phi_hat) at the unit vector n."""
    npv = torch.sqrt(nx * nx + ny * ny)
    inv = 1.0 / torch.clamp(npv, min=1e-30)
    phx, phy = -ny * inv, nx * inv
    thx = nz * nx * inv
    thy = nz * ny * inv
    thz = -npv
    return thx, thy, thz, phx, phy


# ----------------------------------------------------------------------------
# field interpolation + propagation
# ----------------------------------------------------------------------------

def pixel_id_row(W: int, dtype, device, base: int = 0):
    """[W] bit-exact pixel ids base..base+W-1 as a map row: float32 holds
    the int32 id with bit 0x40000000 set (a normal float, so no denormal
    flush can touch it; npix < 2^30 through order 13), float64 the exact
    id."""
    glob = torch.arange(base, base + W, dtype=torch.int32, device=device)
    if dtype == torch.float32:
        return (glob | 0x40000000).view(torch.float32)
    return glob.to(dtype)


def with_pixel_ids(maps, base: int = 0):
    """FieldMaps or stacked [6, W] maps -> [7, W] with the pixel-id row
    (pixel_id_row; base: the global id of column 0, for a window of the
    maps), the maps interp_and_prop_chunk reads."""
    maps6 = maps if isinstance(maps, torch.Tensor) else torch.stack(list(maps))
    ids = pixel_id_row(maps6.shape[1], maps6.dtype, maps6.device, base)
    return torch.cat([maps6, ids[None, :]], dim=0)


def _decode_pixel_ids(row):
    if row.dtype == torch.float32:
        return row.contiguous().view(torch.int32) & 0x3FFFFFFF
    return row.to(torch.int64)


def interp_and_prop_chunk(tab, maps7, chunk, wp, wpm1, wpm2, born: bool,
                          pix_base: int = 0):
    """Packed chunk [21, c]: interpolate (pot, alpha, U) from the six field
    maps with 4-pixel bilinear taps and parallel transport, then propagate
    to radius wp.  Returns the updated packed chunk.

    maps7: [7, npix], the six maps (pot, gt, gp, gtt, gtp, gpp) and the
    pixel-id row (poisson.phase_synthesis' output, or with_pixel_ids of
    the six), made once for all of a plane's chunks.  One gather per tap
    returns the tap's six fields AND its pixel id (the 7th row); the tap's
    ring geometry, weight and transport are rebuilt from that id, so each
    weight is paired with the field it was computed for (rays/soa.py of
    the JAX package, "mispairing-proof tap structure").  pix_base: the
    global pixel of maps7's column 0 when maps7 is a window of the maps
    (parallel/halo.py); taps are read at pixel - pix_base, clamped to the
    window."""
    r = chunk
    nx, ny, nz = r[0], r[1], r[2]
    rad = torch.sqrt(nx * nx + ny * ny + nz * nz)
    hx, hy, hz = nx / rad, ny / rad, nz / rad

    theta = torch.arccos(torch.clamp(hz, -1.0, 1.0))
    phi = torch.atan2(hy, hx)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    pix4, _ = torchhp.get_interpol_soa(tab, theta, phi)

    if pix_base or maps7.shape[1] != tab.npix:
        W = maps7.shape[1]
        pix4 = [torch.clamp(pk - pix_base, 0, W - 1) for pk in pix4]
    fld4 = [torch.index_select(maps7, 1, pk) for pk in pix4]
    return _finish_from_fields(tab, fld4, r, theta, phi, hx, hy, hz,
                               wp, wpm1, wpm2, born)


def _finish_from_fields(tab, fld4, r, theta, phi, hx, hy, hz,
                        wp, wpm1, wpm2, born: bool):
    """Post-gather half of the ray side: decode each tap's true pixel id
    from its gathered 7th row, rebuild its ring geometry and parallel
    transport, form position-based weights, accumulate the six fields and
    propagate.  fld4 is [4][7, c] (6 fields + pixel id)."""
    dt = r.dtype
    nside = tab.nside
    npix_map = tab.npix
    nrings = 4 * nside - 1
    two_pi = 2.0 * math.pi

    cs4, dl4, th4, rg4 = [], [], [], []
    for k in range(4):
        f = fld4[k]
        ring, idx = torchhp.ring_decode_pix(_decode_pixel_ids(f[6]), nside,
                                            npix_map)
        _, nr, shift, thr = torchhp._ring_geo_closed(ring, nside, npix_map, dt)
        dphi = two_pi / nr.to(dt)
        phic = (idx.to(dt) + shift) * dphi
        # signed azimuth offset of the ray from this tap, wrapped to
        # (-pi, pi] (the wrap edge is at the antipode, far from any tap)
        delta = phi - phic
        delta = delta - two_pi * torch.round(delta / two_pi)
        sthr = torch.sin(thr)
        cx = sthr * torch.cos(phic)
        cy = sthr * torch.sin(phic)
        cz = torch.cos(thr)
        cs4.append(_transport_psi(cx, cy, cz, hx, hy, hz))
        dl4.append(delta)
        th4.append(thr)
        rg4.append(ring)

    def az_pair(d0, d1):
        """Linear weights for two taps at signed offsets d0, d1 from the
        ray (exact for any distinct pair)."""
        span = d1 - d0
        safe = span.abs() > 1e-30
        inv = 1.0 / torch.where(safe, span, 1.0)
        a0 = torch.where(safe, d1 * inv, 0.5)
        return a0, 1.0 - a0

    a0, a1 = az_pair(dl4[0], dl4[1])
    a2, a3 = az_pair(dl4[2], dl4[3])

    ring0, ring2 = rg4[0], rg4[2]
    th0, th2 = th4[0], th4[2]
    span_t = th2 - th0
    safe_t = span_t.abs() > 1e-30
    wt = (theta - th0) / torch.where(safe_t, span_t, 1.0)
    wt = torch.where(safe_t, wt, 0.5)
    wg = ((1.0 - wt) * a0, (1.0 - wt) * a1, wt * a2, wt * a3)

    # pole folds (reference get_interpol ir1 == 0 / ir2 == 4nside): the
    # remapped slots land on the same ring as the real pair
    same_ring = ring0 == ring2
    north = same_ring & (ring2 == 1)
    south = same_ring & (ring0 == nrings)
    wtn = theta / th2
    facn = (1.0 - wtn) * 0.25
    wts = (theta - th0) / (math.pi - th0)
    facs = wts * 0.25
    w0 = torch.where(north, facn,
                     torch.where(south, (1.0 - wts) * a0 + facs, wg[0]))
    w1 = torch.where(north, facn,
                     torch.where(south, (1.0 - wts) * a1 + facs, wg[1]))
    w2 = torch.where(north, wtn * a2 + facn, torch.where(south, facs, wg[2]))
    w3 = torch.where(north, wtn * a3 + facn, torch.where(south, facs, wg[3]))
    wgt4 = (w0, w1, w2, w3)

    pot = torch.zeros_like(theta)
    g0 = torch.zeros_like(theta)
    g1 = torch.zeros_like(theta)
    u00 = torch.zeros_like(theta)
    u01 = torch.zeros_like(theta)
    u10 = torch.zeros_like(theta)
    u11 = torch.zeros_like(theta)
    for k in range(4):
        f = fld4[k]
        wk = wgt4[k].to(dt)
        c_, s_ = cs4[k]
        pot = pot + f[0] * wk
        gt, gp = f[1], f[2]
        g0 = g0 + (gt * c_ + gp * s_) * wk
        g1 = g1 + (-gt * s_ + gp * c_) * wk
        t00, t01, t10, t11 = _rot_tensor(c_, s_, f[3], f[4], f[4], f[5])
        u00 = u00 + t00 * wk
        u01 = u01 + t01 * wk
        u10 = u10 + t10 * wk
        u11 = u11 + t11 * wk

    # alpha -= grad, U += hess, phi = pot (shtpoissonsolve.c:686-703)
    return _prop_rows(r, r[14] - g0, r[15] - g1, r[16] + u00, r[17] + u01,
                      r[18] + u10, r[19] + u11, pot, wp, wpm1, wpm2, born)


def _prop_rows(r, al0, al1, U00, U01, U10, U11, pot, wp, wpm1, wpm2,
               born: bool, radial_when_straight: bool = False):
    """Componentwise rayprop_sphere on packed rows (rayprop.c:18-189).

    radial_when_straight mirrors the reference's alpha == 0 branch
    (rayprop.c:125-131): unbent rays move radially instead of along the
    beta chord."""
    nx, ny, nz = r[0], r[1], r[2]
    bx, by, bz = r[3], r[4], r[5]
    A00, A01, A10, A11 = r[6], r[7], r[8], r[9]
    P00, P01, P10, P11 = r[10], r[11], r[12], r[13]

    f = wpm1 * (wp - wpm2) / (wp * (wpm1 - wpm2))
    g = (wp - wpm1) / wp
    if born:
        UA00, UA01, UA10, UA11 = U00, U01, U10, U11
    else:
        UA00 = U00 * A00 + U01 * A10
        UA01 = U00 * A01 + U01 * A11
        UA10 = U10 * A00 + U11 * A10
        UA11 = U10 * A01 + U11 * A11
    N00 = (1.0 - f) * P00 + f * A00 - g * UA00
    N01 = (1.0 - f) * P01 + f * A01 - g * UA01
    N10 = (1.0 - f) * P10 + f * A10 - g * UA10
    N11 = (1.0 - f) * P11 + f * A11 - g * UA11

    rad = torch.sqrt(nx * nx + ny * ny + nz * nz)
    hx, hy, hz = nx / rad, ny / rad, nz / rad

    if born:
        sc = wp / wpm1
        out = [nx * sc, ny * sc, nz * sc, bx, by, bz,
               N00, N01, N10, N11, A00, A01, A10, A11,
               al0, al1, U00, U01, U10, U11, pot]
        return torch.stack(out, dim=0)

    # bend beta by |alpha| about n x avec (rayprop.c:64-107)
    amag = torch.sqrt(al0 * al0 + al1 * al1)
    thx, thy, thz, phx, phy = _tangent_basis(hx, hy, hz)
    avx = al0 * thx + al1 * phx
    avy = al0 * thy + al1 * phy
    avz = al0 * thz
    axx = ny * avz - nz * avy
    axy = nz * avx - nx * avz
    axz = nx * avy - ny * avx
    an = torch.sqrt(axx * axx + axy * axy + axz * axz)
    inv = 1.0 / torch.where(an > 0.0, an, 1.0)
    axx, axy, axz = axx * inv, axy * inv, axz * inv
    ca = torch.cos(amag)
    sa = torch.sin(amag)
    adotb = axx * bx + axy * by + axz * bz
    cxx = axy * bz - axz * by
    cyy = axz * bx - axx * bz
    czz = axx * by - axy * bx
    omc = 1.0 - ca
    bent = amag > 0.0
    bbx = torch.where(bent, bx * ca + axx * adotb * omc + cxx * sa, bx)
    bby = torch.where(bent, by * ca + axy * adotb * omc + cyy * sa, by)
    bbz = torch.where(bent, bz * ca + axz * adotb * omc + czz * sa, bz)

    # geodesic chord |n + lam b| = wp (rayprop.c:109-121)
    qb = 2.0 * (nx * bbx + ny * bby + nz * bbz)
    qc = wpm1 * wpm1 - wp * wp
    disc = torch.sqrt(torch.clamp(qb * qb - 4.0 * qc, min=0.0))
    q = -0.5 * (qb + torch.sign(qb) * disc)
    lam1 = qc / torch.where(q != 0.0, q, 1.0)
    lam = torch.where(lam1 < 0.0, q, lam1)
    if radial_when_straight:
        lam = torch.where(bent, lam, 0.0)  # m = n: radial rescale below
    mx = nx + bbx * lam
    my = ny + bby * lam
    mz = nz + bbz * lam

    # parallel transport A and Aprev to the new position (rayprop.c:151-170)
    mrad = torch.sqrt(mx * mx + my * my + mz * mz)
    ux, uy, uz = mx / mrad, my / mrad, mz / mrad
    c_, s_ = _transport_psi(hx, hy, hz, ux, uy, uz)
    P00n, P01n, P10n, P11n = _rot_tensor(c_, s_, A00, A01, A10, A11)
    A00n, A01n, A10n, A11n = _rot_tensor(c_, s_, N00, N01, N10, N11)

    sc = wp / mrad
    out = [mx * sc, my * sc, mz * sc, bbx, bby, bbz,
           A00n, A01n, A10n, A11n, P00n, P01n, P10n, P11n,
           al0, al1, U00, U01, U10, U11, pot]
    return torch.stack(out, dim=0)


def zero_plane_rows(packed):
    """A copy of packed with the per-plane alpha/U/phi rows reset
    (raytrace.c:213-230); the caller's buffer is left as it was."""
    out = packed.clone()
    out[14:21] = 0.0
    return out


def prop_only_chunk(chunk, wp, wpm1, wpm2, born: bool,
                    radial_when_straight: bool = False):
    """Propagation with this plane's fields already in the rows (particle-
    free planes)."""
    r = chunk
    return _prop_rows(r, r[14], r[15], r[16], r[17], r[18], r[19], r[20],
                      wp, wpm1, wpm2, born,
                      radial_when_straight=radial_when_straight)


def chunked_into(fn, packed, chunk_size):
    """fn over column chunks of packed [21, N] (each chunk's per-plane rows
    reset on a copy, zero_plane_rows), each result written into one
    preallocated [21, N] buffer: the input, one chunk's transients and the
    output are alive at once, never a list of chunk outputs."""
    N = packed.shape[1]
    out = torch.empty_like(packed)
    for a in range(0, N, chunk_size):
        b = min(N, a + chunk_size)
        out[:, a:b] = fn(zero_plane_rows(packed[:, a:b]))
    return out


NOUT = 10


def output_rows_obs_radec(packed, ring_pix, order: int):
    """Packed [21, N] + observer RING pixel [N] -> [10, N] output columns
    (nx, ny, nz, A00, A01, A10, A11, alpha0, alpha1, phi) in the OBSERVER
    frame and (ra, dec) basis (rayio.c:299-347): A parallel-transported
    from the current position back to the initial pixel center, then
    basis-swapped theta-phi -> ra-dec.  Elementwise per ray: the device
    half of the packed ray writer (io/rayio.py:write_rays_packed)."""
    nx, ny, nz = packed[0], packed[1], packed[2]
    inv = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz)
    ox, oy, oz = torchhp.pix2vec_ring_soa(ring_pix, order, packed.dtype)
    c, s = _transport_psi(nx * inv, ny * inv, nz * inv, ox, oy, oz)
    a00, a01, a10, a11 = _rot_tensor(c, s, packed[6], packed[7],
                                     packed[8], packed[9])
    # theta-phi -> ra-dec tensor basis swap (rays/frames.py:_basis_swap)
    return torch.stack([nx, ny, nz, a11, -a10, -a01, a00,
                        packed[15], -packed[14], packed[20]])


def init_packed_fullsky(order: int, wp, npix: int, device,
                        dtype=torch.float32, chunk=1 << 24, pix0: int = 0):
    """Packed ray init for the full sky in RING pixel order (init_rays,
    raytrace_utils.c:302-349): n = wp * pixel center, beta = n_hat,
    A = Aprev = I, for the npix RING pixels from pix0 (a rank's columns on
    a mesh; every pixel by default); the pixel vectors are formed `chunk`
    pixels at a time (at rayOrder 12 one pass over every pixel would hold
    ~10 int64 and float temporaries of 1.6 GB each)."""
    out = torch.zeros((NROWS, npix), dtype=dtype, device=device)
    wp = torch.as_tensor(wp, dtype=dtype, device=device)
    for a in range(0, npix, chunk):
        pix = torch.arange(pix0 + a, pix0 + min(npix, a + chunk),
                           dtype=torch.int64, device=device)
        vx, vy, vz = torchhp.pix2vec_ring_soa(pix, order, dtype=dtype)
        b = a + len(pix)
        out[0, a:b], out[1, a:b], out[2, a:b] = vx * wp, vy * wp, vz * wp
        out[3, a:b], out[4, a:b], out[5, a:b] = vx, vy, vz
    out[6] = out[9] = out[10] = out[13] = 1.0
    return out
