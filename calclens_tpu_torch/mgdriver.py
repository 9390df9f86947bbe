"""Multigrid refinement driver (reference mgpoissonsolve.c:59-297).

Port of calclens_tpu/mgdriver.py.  Non-SHTONLY mode: the
spherical-harmonic solve supplies only the long-range potential map; each
bundle cell then gets a tangent-patch FAS solve (mg.py) whose Dirichlet
boundary values and initial guess are interpolated from that map, and the
rays take their deflection and shear from finite differences of the patch
potential: the short-range force at resolution far beyond lmax.

All C patches solve together as [C, N, N]; the particle deposit scatters
each particle into its cell's patch and the 8 neighbouring cells' patches
(patches overlap, MGPATCH_SIZE_FAC = 4 cell widths), by one
ops/deposit.add_at on a flat view (a fixed order of sums: the same bits on
every run); derivatives at
the rays rotate the patch-basis gradient and Hessian back to the global
(theta, phi) basis with exact 3-vector algebra (fill_uderivs_rays /
rot_tangvectens analog, mgpoissonsolve.c:782-1346).

Memory at the design point (bundleOrder 6: C = 49,152 patches of N = 130,
3.32 GB per float32 field; rayOrder 12: 201 M rays): the BC fill runs in
chunks of cells, and the ray side evaluates the finite-difference stencils
at each ray's four taps, in chunks of rays, instead of building six whole
derivative fields.  With i0, j0 clipped to [1, N-3] every stencil stays
inside the patch, so this is the same function as the JAX package's rolled
whole-field stencils, with the same per-tap operation order.

On a mesh (mg_refine's mesh, parallel/sharding.py) the patch batch is
sharded in contiguous blocks of patches, the JAX _cst_patch layout: each
rank deposits its particle rows into a whole [C, N, N] partial grid, one
reduce-scatter sums it onto the ranks' patch blocks
(_deposit_patches_sharded), the BC fill and every FAS cycle run on the
rank's patches (the MGConvFact test agreed over the ranks), and one
all-gather of the solved patches feeds the rank's rays.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import mg
from .healpix import core as hp
from .healpix import torchhp
from .ops.deposit import add_at

# patch cells per chunk of the BC fill, as a number of [N, N] elements
FILL_CHUNK_ELEMS = 1 << 24
# the SPH patch deposit: stamps wider than FFT_STAMP cells are applied by
# FFT, in chunks of cells of FFT_CHUNK_ELEMS spectrum elements
FFT_STAMP = 31
FFT_CHUNK_ELEMS = 1 << 26


def cell_rotations(bundle_order):
    """R[c] rotating cell c's center to (theta=pi/2, phi=0):
    R = Ry(pi/2 - theta_c) @ Rz(-phi_c).  Host, [C, 3, 3]."""
    npix = int(hp.order2npix(bundle_order))
    nest = np.arange(npix)
    theta, phi = hp.pix2ang_nest(nest, bundle_order)
    ca, sa = np.cos(-phi), np.sin(-phi)
    Rz = np.zeros((npix, 3, 3))
    Rz[:, 0, 0] = ca
    Rz[:, 0, 1] = -sa
    Rz[:, 1, 0] = sa
    Rz[:, 1, 1] = ca
    Rz[:, 2, 2] = 1.0
    b = np.pi / 2 - theta
    cb, sb = np.cos(b), np.sin(b)
    Ry = np.zeros((npix, 3, 3))
    Ry[:, 0, 0] = cb
    Ry[:, 0, 2] = sb
    Ry[:, 1, 1] = 1.0
    Ry[:, 2, 0] = -sb
    Ry[:, 2, 2] = cb
    return np.einsum("cij,cjk->cik", Ry, Rz)


class MGSetup:
    """Static per-run tables for the batched patch solve: host numpy arrays
    as in the JAX package, and their device copies (`dev`), built once per
    (name, dtype, device)."""

    def __init__(self, bundle_order, patch_n, ray_order=None,
                 dtype=torch.float32):
        self.bundle_order = bundle_order
        self.ray_order = ray_order
        self.C = int(hp.order2npix(bundle_order))
        cell_size = np.sqrt(4.0 * np.pi / self.C)
        self.Lpatch = float(mg.MGPATCH_SIZE_FAC * cell_size)
        self.levels = tuple(mg.build_levels(self.Lpatch, patch_n))
        self.dtype = dtype
        self.R = cell_rotations(bundle_order)              # [C, 3, 3]
        self.R9 = np.ascontiguousarray(
            self.R.reshape(self.C, 9).T)                   # [9, C]
        self.neighbors = np.concatenate(
            [np.arange(self.C)[:, None],
             hp.neighbors_nest(np.arange(self.C), bundle_order)], axis=1)
        self.neighbors = np.where(self.neighbors < 0,
                                  self.neighbors[:, :1], self.neighbors)
        # RING -> NEST at bundleOrder, for the particles' cells
        self.r2n = hp.ring2nest(np.arange(self.C), bundle_order)
        # the fine level's rows: cell solid angles / dL, sin and cot theta
        lev = self.levels[0]
        th = np.arange(lev.N) * lev.dL + lev.thetaLoc
        self.cosfacs = np.asarray(lev.cosfacs)
        self.sin_c = np.asarray(lev.sin_c)
        self.cot_c = np.cos(th) / np.sin(th)
        # static sigma bucket centers for the spline patch deposit (set by
        # the driver when DepositScheme is SPH)
        self.sph_sigmas = None
        self._dev = {}

    def dev(self, name, dtype, device, build=None):
        """Device copy of the host table `name` (float tables in dtype,
        integer tables as int64), made once: a host -> device copy inside
        the step would wait for the work queued before it.  build() gives
        the host array of a table that is not an attribute."""
        key = (name, dtype, str(device))
        if key not in self._dev:
            x = np.asarray(build() if build else getattr(self, name))
            dt = torch.int64 if x.dtype.kind in "iu" else dtype
            self._dev[key] = torch.as_tensor(x, dtype=dt, device=device)
        return self._dev[key]

    def patch_coords_soa(self, r9, v0, v1, v2):
        """Componentwise patch coordinates: r9 = 9 row-major rotation
        components (each broadcastable against v0/v1/v2).  Returns
        (ti, pj, ok) fractional grid indices and validity, plus the rotated
        components (w0, w1, w2)."""
        lev = self.levels[0]
        w0 = r9[0] * v0 + r9[1] * v1 + r9[2] * v2
        w1 = r9[3] * v0 + r9[4] * v1 + r9[5] * v2
        w2 = r9[6] * v0 + r9[7] * v1 + r9[8] * v2
        theta = torch.arccos(torch.clamp(w2, -1.0, 1.0))
        phi = torch.atan2(w1, w0)
        ti = (theta - lev.thetaLoc) / lev.dL
        pj = (phi - lev.phiLoc) / lev.dL
        ok = (ti >= 0) & (ti < lev.N - 1) & (pj >= 0) & (pj < lev.N - 1)
        return ti, pj, ok, (w0, w1, w2)


def _cic_patch_mass(setup: MGSetup, pos, w):
    """CIC scatter of per-particle weights w [Np] into every particle's own
    and neighbouring patches -> mass grid [C, N, N]."""
    lev = setup.levels[0]
    N = lev.N
    dt, dev = pos.dtype, pos.device
    theta, phi = torchhp.vec2ang(pos)
    cell = setup.dev("r2n", dt, dev)[
        torchhp.ang2pix_ring(theta, phi, setup.bundle_order)]
    cand = setup.dev("neighbors", dt, dev)[cell]              # [Np, 9]
    del theta, phi, cell
    R9 = setup.dev("R9", dt, dev)
    r9 = [R9[k][cand] for k in range(9)]                      # 9 x [Np, 9]
    nhat = pos / torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    ti, pj, ok, _ = setup.patch_coords_soa(
        r9, nhat[:, 0:1], nhat[:, 1:2], nhat[:, 2:3])
    del r9
    i0 = torch.clamp(torch.floor(ti).long(), 0, N - 2)
    j0 = torch.clamp(torch.floor(pj).long(), 0, N - 2)
    fx = torch.clamp(ti - i0, 0.0, 1.0)
    fy = torch.clamp(pj - j0, 0.0, 1.0)
    wk = torch.where(ok, w[:, None], 0.0)
    grid = torch.zeros(setup.C * N * N, dtype=dt, device=dev)
    base = (cand * N + i0) * N + j0
    idx, val = [], []
    for di in (0, 1):
        wi = (1.0 - fx) if di == 0 else fx
        for dj in (0, 1):
            wj = (1.0 - fy) if dj == 0 else fy
            idx.append((base + (di * N + dj)).reshape(-1))
            val.append((wk * wi * wj).reshape(-1))
    del base, fx, fy, wk
    # the four corners' adds in the JAX package's order, as one add_at
    return add_at(grid, torch.cat(idx), torch.cat(val)).view(setup.C, N, N)


def _scale_patch_density(setup: MGSetup, grid, densfact, backdens):
    """mass -> kappa source in place (fill_rho_mggrid:246-255):
      rho[i,j] = mass_in_cell / (dL * cosfacs_i) * densfact - backdens."""
    cosf = setup.dev("cosfacs", grid.dtype, grid.device)[None, :, None]
    return grid.div_(setup.levels[0].dL * cosf).mul_(densfact).sub_(backdens)


def deposit_patches(setup: MGSetup, pos, mass, densfact, backdens):
    """CIC deposit of every particle into its own and neighbouring patches,
    scaled to the kappa source term [C, N, N]."""
    return _scale_patch_density(setup, _cic_patch_mass(setup, pos, mass),
                                densfact, backdens)


def _kernel_stamp(sigma, dL, max_half=None):
    """Normalized Epanechnikov stamp [K, K] on the patch grid (equatorial
    metric: the patch is rotated so its center sits on the equator, so
    sin(theta) deviates from 1 only by O((L/2)^2) at the edges).  max_half
    crops the normalized stamp to offsets |d| <= max_half cells: on an
    [N, N] grid with "same" padding, offsets beyond N - 1 only ever meet
    the padding."""
    half = max(int(np.ceil(sigma / dL)), 1)
    d = np.arange(-half, half + 1) * dL
    g2 = d[:, None] ** 2 + d[None, :] ** 2
    w = np.maximum(1.0 - g2 / sigma**2, 0.0)
    w = w / w.sum()
    if max_half is not None and half > max_half:
        w = w[half - max_half: half + max_half + 1,
              half - max_half: half + max_half + 1]
    return w


def _fft_size(n):
    """The smallest 2^a 3^b 5^c >= n (a fast FFT length)."""
    m = n
    while True:
        r = m
        for p in (2, 3, 5):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def _conv_same(grid, stamp):
    """[C, N, N] grid convolved with an odd, symmetric [K, K] stamp, "same"
    padding (the JAX package's conv_general_dilated "SAME"), in the grid's
    precision.  Stamps up to FFT_STAMP cells wide run as F.conv2d with
    cuDNN's TF32 switched off; wider ones as the full linear convolution by
    real FFTs of length >= N + K - 1 (no wrap-around), cropped, in chunks of
    cells: cuDNN's direct float32 convolution with a 259^2 stamp takes
    seconds per bucket at bundleOrder 6."""
    K = stamp.shape[-1]
    half = (K - 1) // 2
    if K <= FFT_STAMP:
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return F.conv2d(grid[:, None], stamp[None, None],
                            padding=half)[:, 0]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    C, N, _ = grid.shape
    L = _fft_size(N + K - 1)
    ws = torch.fft.rfft2(stamp, s=(L, L))
    out = torch.empty_like(grid)
    step = max(1, FFT_CHUNK_ELEMS // (L * (L // 2 + 1)))
    for a in range(0, C, step):
        g = torch.fft.rfft2(grid[a:a + step], s=(L, L))
        g *= ws
        out[a:a + step] = torch.fft.irfft2(g, s=(L, L))[
            :, half:half + N, half:half + N]
        del g
    return out


def deposit_patches_sph(setup: MGSetup, pos, mass, sl, densfact, backdens,
                        sigmas):
    """Spline-kernel patch deposit (fill_rho_mggrid, mgpoissonsolve.c:
    299-597): each particle's mass is split between the two bracketing
    sigma buckets (linearly in ln sigma), each bucket's CIC mass grid is
    convolved with the bucket's normalized Epanechnikov stamp ("same"
    padding: the JAX package's conv_general_dilated; _conv_same), and the
    buckets are summed (_sph_patch_mass), then scaled to the kappa source
    term."""
    return _scale_patch_density(
        setup, _sph_patch_mass(setup, pos, mass, sl, sigmas), densfact,
        backdens)


def _sph_patch_mass(setup: MGSetup, pos, mass, sl, sigmas):
    """The smoothed mass grid [C, N, N] of deposit_patches_sph, unscaled.
    The buckets run one after another, so one [C, N, N] temporary lives at
    a time beside the sum."""
    lev = setup.levels[0]
    B = len(sigmas)
    logsig = torch.log(setup.dev(("sigmas", tuple(sigmas)), sl.dtype,
                                 sl.device, lambda: sigmas))
    logsl = torch.log(sl)
    hi = torch.clamp(torch.searchsorted(logsig, logsl), 1, B - 1)
    lo = hi - 1
    t = torch.clamp((logsl - logsig[lo]) / (logsig[hi] - logsig[lo]),
                    0.0, 1.0)
    grid = None
    for b, sig in enumerate(sigmas):
        wb = (mass * torch.where(lo == b, 1.0 - t, 0.0)
              + mass * torch.where(hi == b, t, 0.0))
        gb = _cic_patch_mass(setup, pos, wb)
        stamp = setup.dev(("stamp", float(sig)), pos.dtype, pos.device,
                          lambda: _kernel_stamp(float(sig), lev.dL,
                                                max_half=lev.N - 1))
        conv = _conv_same(gb, stamp)
        del gb
        grid = conv if grid is None else grid.add_(conv)
        del conv
    return grid


def _deposit_patches_sharded(setup: MGSetup, mesh, pos, mass, densfact,
                             backdens, sl=None, sigmas=None):
    """The patch deposit on a mesh: pos, mass (and sl) are this rank's
    particle rows, deposited into a whole [C, N, N] partial mass grid; one
    reduce-scatter sums the ranks' grids onto this rank's block of patches
    (mesh.blocks(C): uneven blocks need no C % n == 0), which is scaled
    there.  This is the reference's particle exchange (mgpoissonsolve.c:
    59-123) as one collective.  SPH: each rank convolves its own bucket
    grids with the stamps (the convolution is linear and per patch) and
    the smoothed grid is reduce-scattered once; the JAX package
    reduce-scatters each bucket's grid and convolves on the shard: the same
    sums up to rounding, one reduce-scatter instead of one per bucket."""
    if sl is None:
        grid = _cic_patch_mass(setup, pos, mass)
    else:
        grid = _sph_patch_mass(setup, pos, mass, sl, sigmas)
    rho = mesh.reduce_scatter_rows(grid)
    del grid
    return _scale_patch_density(setup, rho, densfact, backdens)


def _patch_centers_soa(setup: MGSetup, li: int, cells, dtype, device):
    """Componentwise global unit vectors (vx, vy, vz) of the patch cell
    centers of level li, each [len(cells), N, N], for the cell indices
    `cells` (a slice or index tensor)."""
    lev = setup.levels[li]
    i = torch.arange(lev.N, dtype=dtype, device=device)
    th = i * lev.dL + lev.thetaLoc
    ph = i * lev.dL + lev.phiLoc
    sth, cth = torch.sin(th), torch.cos(th)
    sph, cph = torch.sin(ph), torch.cos(ph)
    px = torch.outer(sth, cph)
    py = torch.outer(sth, sph)
    pz = cth[:, None].expand(lev.N, lev.N)
    R = setup.dev("R", dtype, device)[cells]                  # [c, 3, 3]

    # global = R^T v_patch, componentwise over the 9 rotation entries
    def comp(col):
        return (R[:, 0, col][:, None, None] * px
                + R[:, 1, col][:, None, None] * py
                + R[:, 2, col][:, None, None] * pz)

    return comp(0), comp(1), comp(2)


def fill_u_from_map(setup: MGSetup, tab, potmap, c0=0, c1=None):
    """Initial guess + Dirichlet BCs: interpolate the SHT potential map
    (RING, whole) at every patch cell center (fill_u_mggrid /
    fill_bcs_mggrid) of the patches c0..c1 (all by default), in chunks of
    cells.  Returns [c1 - c0, N, N] in potmap's dtype."""
    lev = setup.levels[0]
    N = lev.N
    dt, dev = potmap.dtype, potmap.device
    c1 = setup.C if c1 is None else c1
    u = torch.empty((c1 - c0, N, N), dtype=dt, device=dev)
    step = max(1, FILL_CHUNK_ELEMS // (N * N))
    for a in range(c0, c1, step):
        cells = slice(a, min(c1, a + step))
        vx, vy, vz = _patch_centers_soa(setup, 0, cells, dt, dev)
        theta = torch.arccos(torch.clamp(vz, -1.0, 1.0))
        phi = torch.atan2(vy, vx)
        del vx, vy, vz
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        pix4, wgt4 = torchhp.get_interpol_soa(tab, theta, phi)
        del theta, phi
        acc = potmap[pix4[0]] * wgt4[0]
        for k in range(1, 4):
            acc += potmap[pix4[k]] * wgt4[k]
        u[a - c0: cells.stop - c0] = acc
        del pix4, wgt4, acc
    return u


def solve_patches(setup: MGSetup, u0, rho, conv_fact=-1.0, max_cycles=20,
                  mesh=None):
    """Batched patch solve; conv_fact > 0 enables the reference's
    truncation-error-relative stopping rule (MGConvFact, README.md:215-221,
    default 0.1), else a fixed 10-cycle solve.  On a mesh u0 and rho are
    the rank's patches and the stopping test covers every rank's.  Returns
    (u, cycles)."""
    if conv_fact <= 0:
        return mg.solve_fas(u0, rho, setup.levels, 10, 2, 2), 10
    return mg.solve_fas_adaptive(
        u0, rho, setup.levels, conv_fact, max_cycles, 2, 2,
        agree=None if mesh is None else mesh.all_true)


def _tangent_basis_soa(n0, n1, n2):
    """Componentwise tangent basis at unit (n0, n1, n2): (that_x, that_y,
    that_z, phat_x, phat_y); phat_z is identically 0."""
    npv = torch.clamp(torch.sqrt(n0 * n0 + n1 * n1), min=1e-30)
    inv = 1.0 / npv
    return (n2 * n0 * inv, n2 * n1 * inv, -(n0 * n0 + n1 * n1) * inv,
            -n1 * inv, n0 * inv)


def interp_derivs_to_rays(setup: MGSetup, u, ray_vec, cell):
    """Finite-difference derivatives of the patch potential u [C, N, N] at
    the rays ray_vec [3, Nr] (any radius; cell: each ray's NEST bundle
    cell), rotated to the global (theta, phi) basis.  Returns the
    componentwise (pot, g0, g1, h00, h01, h10, h11), each [Nr], with the
    SHT interpolation's conventions (alpha -= grad, U += hess); 0 for a ray
    outside its patch.

    Each tap (i, j) of the bilinear sample evaluates the central
    differences of getderiv_mggrid_* from the 4 x 4 block of u around the
    ray (i0 - 1 .. i0 + 2, j0 - 1 .. j0 + 2), stencil first, then the
    weights."""
    lev = setup.levels[0]
    N = lev.N
    dL = lev.dL
    dt, dev = u.dtype, u.device
    R9 = setup.dev("R9", dt, dev)
    r9 = [R9[k][cell] for k in range(9)]
    inv = 1.0 / torch.sqrt(ray_vec[0] * ray_vec[0] + ray_vec[1] * ray_vec[1]
                           + ray_vec[2] * ray_vec[2])
    n0 = ray_vec[0] * inv
    n1 = ray_vec[1] * inv
    n2 = ray_vec[2] * inv
    del inv
    ti, pj, ok, (v0, v1, v2) = setup.patch_coords_soa(r9, n0, n1, n2)
    i0 = torch.clamp(torch.floor(ti).long(), 1, N - 3)
    j0 = torch.clamp(torch.floor(pj).long(), 1, N - 3)
    fx = ti - i0
    fy = pj - j0
    del ti, pj

    # the 4 x 4 block around the ray: blk[a][b] = u[cell, i0-1+a, j0-1+b]
    flat = u.reshape(-1)
    base = (cell * N + (i0 - 1)) * N + (j0 - 1)
    blk = [[flat[base + (a * N + b)] for b in range(4)] for a in range(4)]
    del base
    sc = setup.dev("sin_c", dt, dev)
    cotv = setup.dev("cot_c", dt, dev)

    def tap_fields(di, dj):
        """(u, gt, gp, gtt, gtp, gpp) at (cell, i0 + di, j0 + dj)."""
        a, b = 1 + di, 1 + dj
        c = blk[a][b]
        up, dn = blk[a - 1][b], blk[a + 1][b]
        lf, rt = blk[a][b - 1], blk[a][b + 1]
        s = sc[i0 + di]
        cv = cotv[i0 + di]
        gt = (dn - up) / (2 * dL)
        gp = (rt - lf) / (2 * dL) / s
        gtt = (up + dn - 2 * c) / (dL * dL)
        gpp_raw = (lf + rt - 2 * c) / (dL * dL) / (s ** 2)
        gtp_raw = (blk[a + 1][b + 1] - blk[a + 1][b - 1]
                   - blk[a - 1][b + 1] + blk[a - 1][b - 1]
                   ) / (4 * dL * dL) / s
        return (c, gt, gp, gtt, gtp_raw - cv * gp, gpp_raw + cv * gt)

    f00, f10 = tap_fields(0, 0), tap_fields(1, 0)
    f01, f11 = tap_fields(0, 1), tap_fields(1, 1)
    del blk
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    pot, gt, gp, gtt, gtp, gpp = (
        w00 * f00[k] + w10 * f10[k] + w01 * f01[k] + w11 * f11[k]
        for k in range(6))
    del f00, f10, f01, f11

    # patch-frame basis vectors at the ray, expressed globally
    tp0, tp1, tp2, pp0, pp1 = _tangent_basis_soa(v0, v1, v2)
    # global = R^T patch-frame (transpose = column-major rows of R9)
    tg_0 = r9[0] * tp0 + r9[3] * tp1 + r9[6] * tp2
    tg_1 = r9[1] * tp0 + r9[4] * tp1 + r9[7] * tp2
    tg_2 = r9[2] * tp0 + r9[5] * tp1 + r9[8] * tp2
    pg_0 = r9[0] * pp0 + r9[3] * pp1
    pg_1 = r9[1] * pp0 + r9[4] * pp1
    pg_2 = r9[2] * pp0 + r9[5] * pp1
    t0, t1, t2, p0, p1 = _tangent_basis_soa(n0, n1, n2)
    # B[a,b] = global basis a . rotated patch basis b
    B00 = t0 * tg_0 + t1 * tg_1 + t2 * tg_2
    B01 = t0 * pg_0 + t1 * pg_1 + t2 * pg_2
    B10 = p0 * tg_0 + p1 * tg_1
    B11 = p0 * pg_0 + p1 * pg_1

    okf = ok.to(dt)
    g0 = (B00 * gt + B01 * gp) * okf
    g1 = (B10 * gt + B11 * gp) * okf
    # hess = B H B^T, H = [[gtt, gtp], [gtp, gpp]]
    M00 = B00 * gtt + B01 * gtp
    M01 = B00 * gtp + B01 * gpp
    M10 = B10 * gtt + B11 * gtp
    M11 = B10 * gtp + B11 * gpp
    h00 = (M00 * B00 + M01 * B01) * okf
    h01 = (M00 * B10 + M01 * B11) * okf
    h10 = (M10 * B00 + M11 * B01) * okf
    h11 = (M10 * B10 + M11 * B11) * okf
    return pot * okf, g0, g1, h00, h01, h10, h11


def ray_cells(ray_nest, a, b, ray_order, bundle_order, device, col0=0):
    """NEST bundle cell of the rays a..b: full-sky rays (ray_nest None) sit
    at RING pixel = col0 + storage index (col0: the first column a rank
    holds on a mesh), whose NEST index is taken on the device; otherwise
    ray_nest (a tensor on the device, the rays' own rows) holds each ray's
    NEST pixel."""
    shift = 2 * (ray_order - bundle_order)
    if ray_nest is None:
        nest = torchhp.ring2nest_dev(
            torch.arange(col0 + a, col0 + b, dtype=torch.int32,
                         device=device), ray_order)
        return nest.long() >> shift
    return ray_nest[a:b] >> shift


def mg_refine(setup: MGSetup, tab, rows, ray_nest, ray_order, potmap, pos,
              mass, densfact, backdens, conv_fact=-1.0, sl=None,
              phase=None, mesh=None, col0=0):
    """Full refinement: deposit, BC fill, batched FAS solve, and the rays'
    fields.  Returns (field(a, b), cycles): field(a, b) gives the rays
    a..b's (pot, g0, g1, h00, h01, h10, h11) from the solved patches, the
    caller's INTERP step (poisson.plane_step_mg), which sets phi and adds
    -grad to alpha and hess to U.  rows(a, b) returns their packed
    position rows [3, b - a].

    potmap: RING-ordered SHT potential map (long range / boundary data),
    whole.  sl (per-particle angular smoothing lengths) switches the patch
    deposit to the spline kernel; conv_fact > 0 enables MGConvFact
    stopping.  phase(tag, fn, *args) wraps each part (MGDEPOSIT, MGBC,
    MGSOLVE).

    mesh (a parallel.sharding.Mesh) shards the patch batch over the ranks:
    pos, mass and sl are this rank's particle rows, the deposit
    reduce-scatters into this rank's block of patches (mesh.blocks(C)),
    the BC fill and every FAS cycle run on that block (the MGConvFact test
    agreed over the ranks each cycle), and only the solved [C, N, N]
    potential is all-gathered for the rays (the JAX _cst_patch with
    replicate=True).  The long-range potmap stays whole on every rank: in
    non-SHTONLY mode the SHT order is low (MG supplies the small scales),
    so the map is small by design (poissondrivers.c:64-75).  The rays a..b
    are this rank's columns: ray_nest holds their own NEST pixels, or,
    for full-sky rays, col0 is the global index of the rank's first
    column (Raytracer.ray_bounds)."""
    phase = phase or (lambda tag, fn, *args: fn(*args))
    c0, c1 = (0, setup.C) if mesh is None else mesh.block(setup.C)
    if mesh is not None:
        rho = phase("MGDEPOSIT", _deposit_patches_sharded, setup, mesh, pos,
                    mass, densfact, backdens, sl, setup.sph_sigmas)
    elif sl is not None:
        rho = phase("MGDEPOSIT", deposit_patches_sph, setup, pos, mass, sl,
                    densfact, backdens, setup.sph_sigmas)
    else:
        rho = phase("MGDEPOSIT", deposit_patches, setup, pos, mass,
                    densfact, backdens)
    u0 = phase("MGBC", fill_u_from_map, setup, tab, potmap, c0, c1)
    u, cycles = phase("MGSOLVE", solve_patches, setup, u0, rho, conv_fact,
                      20, mesh)
    del rho, u0
    if mesh is not None:
        u = phase("MGSOLVE", mesh.all_gather_rows, u, mesh.blocks(setup.C))

    def field(a, b):
        cell = ray_cells(ray_nest, a, b, ray_order, setup.bundle_order,
                         u.device, col0)
        return interp_derivs_to_rays(setup, u, rows(a, b), cell)

    return field, cycles
