"""3D FFT potential path (THREEDPOT; reference fftpoissondriver.c +
fftpoissonsolve.c), on the Raytracer's device.

Port of calclens_tpu/fftpot.py.  Alternative to the spherical solvers: per
lens plane pick the nearest N-body snapshot, CIC-deposit its particles onto
an NFFT^3 periodic grid, solve
  phi(k) = potfact * grfcn(k) / W_cic(k)^2 * rho(k),
    potfact = 4 pi G / a * m_p / L^3      (fftpoissonsolve.c:62)
    grfcn   = -dL^2 / (4 sum_i sin^2(k_i dL / 2))   (discrete Laplacian)
    W_cic deconvolved twice (deposit + ray interpolation), zero mode nulled
(fftpoissonsolve.c:330-380), then integrate the Cartesian first/second
derivatives of phi along each ray's radial path through the plane's shell
with central differences + trilinear sampling, projecting onto the ray's
(theta, phi) basis (fftpoissondriver.c:153-1119):
  alpha_i = -(2/c^2) dchi sum_n  dphi/dx_c  J[c,i]
  U_ij    =  (2/c^2) dchi chi sum_n d2phi/dx_c dx_d J[c,i] J[d,j]  (symmetrized)
  phi_ray =  (2/c^2) (dchi/chi) sum_n phi

The FFTs are torch.fft's (cuFFT on the card).  The deposit and the solve
round as the JAX package does under x64, in a float32 run and a float64 run
alike: float32 positions, counts and forward transform, the kernel and the
inverse transform in float64, the potential grid cast to float32.  Every file of a multi-file snapshot is
deposited (the JAX package reads only the first, ROADMAP Queue 3).

The ray side works on the packed [21, N] buffer in column chunks, so the
memory of a step is bounded at any ray count.  The JAX package forms ten
grids (phi, three first and six second central differences) and samples
each trilinearly; here each sample's 4x4x4 block of phi is gathered once,
by one indexing op on an overlapping strided view of the grid padded
periodically, and the ten fields' values at the 8 trilinear corners are
formed from it.  Each corner's difference is rounded as JAX rounds its
derivative grid (in the grid's float32, then divided in the rays' dtype),
so the function stays JAX's.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .cosmology import RHO_CRIT, CSOL
from .ops.deposit import add_at
from .poisson import RAY_CHUNK
from .utils.profile import count
from .utils.profile import phase as default_phase

FOUR_PI_G = 5.4061952545633574e-8  # Mpc (km/s)^2 / Msun (fftpoissonsolve.h:20)

# particles per chunk of the CIC deposit
CIC_CHUNK = 1 << 24
# ray samples (rays x nint) per chunk of the path sampling: the chunk's
# 4x4x4 blocks take 256 bytes per sample in float32
SAMPLES_PER_CHUNK = 1 << 21
# the angular scale that sizes the grid when NFFT is 0 (choose_nfft), as
# the JAX driver passes it
MIN_SL = 0.01


def read_snap_list(path, cosmo, length_conv=1.0):
    """ThreeDPotSnapList: one snapshot basename per line ('#' comments).
    Returns list of dicts {fname, a, chi, L, npart_total}
    (fftpoissondriver.c read_snaps)."""
    from .io import lgadget

    snaps = []
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fn = line + ".0" if os.path.exists(line + ".0") else line
            hd = lgadget.read_header(fn)
            snaps.append(dict(
                fname=line, a=hd["time"],
                chi=float(cosmo.comvdist(hd["time"])),
                L=hd["boxsize"] * length_conv,
                npart_total=hd["npart_total"],
            ))
    return snaps


def snapshot_files(fname):
    """The files of a snapshot: <fname>.0 .. <fname>.<num_files - 1> when
    <fname>.0 exists (num_files from its header), else <fname> alone
    (fftpoissonsolve.c:439-..., every file of the group)."""
    from .io import lgadget

    if not os.path.exists(fname + ".0"):
        return [fname]
    nfiles = max(1, lgadget.read_header(fname + ".0")["num_files"])
    return [f"{fname}.{i}" for i in range(nfiles)]


def nearest_snap(snaps, plane_rad):
    return min(range(len(snaps)), key=lambda i: abs(snaps[i]["chi"] - plane_rad))


def choose_nfft(L, plane_rad, min_sl, max_nfft=-1):
    """Grid size from the minimum smoothing scale (fftpoissondriver.c:109-129):
    cell ~ planeRad*minSL/2, rounded to a 2^k * {1,3,5,7} size."""
    want = max(16, int(L / (plane_rad * min_sl / 2.0)))
    best, bestdiff = None, None
    k = int(np.log2(want))
    for dk in range(-2, 3):
        for pf in (1, 3, 5, 7):
            cand = int(2 ** max(k + dk, 2) * pf)
            d = abs(cand - want)
            if bestdiff is None or d < bestdiff:
                best, bestdiff = cand, d
    if max_nfft > 0:
        best = min(best, max_nfft)
    return best


def cic_deposit_3d(pos, nfft: int, L, out=None):
    """Periodic CIC of unit-weight particles pos [N, 3] (a tensor, in its
    own dtype) onto a float32 [nfft]^3 grid of counts, added into out when
    given.  The 8 corners are added in the JAX package's order, in chunks of
    CIC_CHUNK particles, by one ops/deposit.add_at per chunk on the flat
    grid (a fixed order of sums: the same bits on every run)."""
    L = torch.as_tensor(L, dtype=pos.dtype, device=pos.device)
    dL = L / nfft
    grid = out if out is not None else torch.zeros(
        (nfft, nfft, nfft), dtype=torch.float32, device=pos.device)
    flat = grid.view(-1)
    for a in range(0, len(pos), CIC_CHUNK):
        u = pos[a: a + CIC_CHUNK] / dL - 0.5
        i0f = torch.floor(u)
        f = u - i0f
        i0 = i0f.to(torch.int64)
        del u, i0f
        idx, val = [], []
        for dx in (0, 1):
            wx = 1.0 - f[:, 0] if dx == 0 else f[:, 0]
            ix = torch.remainder(i0[:, 0] + dx, nfft) * (nfft * nfft)
            for dy in (0, 1):
                wy = 1.0 - f[:, 1] if dy == 0 else f[:, 1]
                ixy = ix + torch.remainder(i0[:, 1] + dy, nfft) * nfft
                for dz in (0, 1):
                    wz = 1.0 - f[:, 2] if dz == 0 else f[:, 2]
                    idx.append(ixy + torch.remainder(i0[:, 2] + dz, nfft))
                    val.append((wx * wy * wz).to(torch.float32))
        del f, i0
        add_at(flat, torch.cat(idx), torch.cat(val))
        del idx, val
    return grid


def _poisson_kern(kx, ky, kz, dL, potfact):
    """Discrete Green function x double CIC deconvolution at physical wave
    vectors (broadcastable [n,1,1]/[1,m,1]/[1,1,k]); zero mode zeroed
    (fftpoissonsolve.c:300-417)."""
    def s2(k):
        return torch.sin(k * dL / 2.0) ** 2

    s = s2(kx) + s2(ky) + s2(kz)
    grfcn = -dL * dL / 4.0 / torch.where(s > 0, s, 1.0)
    kny = math.pi / dL

    def w1(k):
        x = math.pi * torch.abs(k) / (2.0 * kny)
        return torch.where(k != 0.0,
                           torch.sin(x) / torch.where(x != 0, x, 1.0), 1.0)

    w = (w1(kx) * w1(ky) * w1(kz)) ** 2
    kern = potfact * grfcn / torch.where(w > 0, w * w, 1.0)
    return torch.where((kx == 0) & (ky == 0) & (kz == 0), 0.0, kern)


def potential_from_counts(counts, nfft: int, L, a, mp):
    """Counts grid -> float32 potential grid (fftpoissonsolve.c:300-417).
    L, a and mp enter in float32 and the forward transform is taken of the
    float32 counts, as the JAX package takes them; the kernel is built in
    float64 and the inverse transform runs in complex128, as JAX's under
    x64 (in float32 they would double the card's distance from a float64
    solve)."""
    return solve_potential(counts.to(torch.float32), nfft, L, a,
                           mp).to(torch.float32)


def solve_potential(rho, nfft: int, L, a, mp, scalar_dtype=torch.float32):
    """The solve of potential_from_counts on rho in its own dtype (complex64
    forward transform for float32 rho, complex128 for float64): the scalars
    (dL, potfact) in scalar_dtype, the kernel in float64.  Returns the
    float64 potential, not cast."""
    def s(x):
        return torch.as_tensor(x, dtype=scalar_dtype, device=rho.device)

    L, a, mp = s(L), s(a), s(mp)
    dL = L / nfft
    # the reference folds the unnormalized-FFTW 1/N^3 into mp/L^3
    # (fftpoissonsolve.c:62); torch.fft.irfftn normalizes, so use mp/dL^3
    potfact = FOUR_PI_G / a * mp / (dL * dL * dL)
    spec = torch.fft.rfftn(rho)
    kfull = 2.0 * math.pi * torch.fft.fftfreq(
        nfft, dtype=torch.float64, device=rho.device) / dL * 1.0
    khalf = 2.0 * math.pi * torch.fft.rfftfreq(
        nfft, dtype=torch.float64, device=rho.device) / dL
    kern = _poisson_kern(kfull[:, None, None], kfull[None, :, None],
                         khalf[None, None, :], dL, potfact)
    spec = spec.to(torch.result_type(spec, kern)).mul_(kern)
    del kern
    return torch.fft.irfftn(spec, s=(nfft, nfft, nfft))


def potential_from_counts_slab(counts_slab, nfft: int, L, a, mp, mesh):
    """Slab-decomposed variant (reference DD-4, fftw3-mpi slab
    decomposition; parallel/slabfft.py): counts_slab is this rank's x-slab
    [nfft / n, nfft, nfft] of the counts (the JAX function takes the whole
    grid and constrains it to x-slabs), and the result is the same x rows
    of the float32 potential.  The kernel is _poisson_kern's at the same
    potfact and wave vectors (fftfreq times kscale), in float32, and the
    whole solve runs in complex64, as the JAX package's slab solve."""
    from .parallel import slabfft

    dL = L / nfft
    potfact = FOUR_PI_G / a * mp / (dL * dL * dL)
    kscale = 2.0 * math.pi / (nfft * dL)

    def kern_fn(fx, fy, fz):
        return _poisson_kern(fx * kscale, fy * kscale, fz * kscale, dL,
                             potfact)

    return slabfft.poisson_slab(counts_slab.to(torch.float32), nfft, kern_fn,
                                mesh).to(torch.float32)


def compute_potential_grid(pos, L, nfft, a, omega_m, n_total):
    """Snapshot particles (numpy or a tensor) -> float32 potential grid; mp
    from the mean density (fftpoissonsolve.c:61).  The deposit runs on
    float32 positions."""
    mp = RHO_CRIT * omega_m * L ** 3 / n_total
    if not isinstance(pos, torch.Tensor):
        pos = torch.from_numpy(np.asarray(pos, np.float32))
    pos = pos.to(torch.float32)
    counts = cic_deposit_3d(pos, nfft, L)
    return potential_from_counts(counts, nfft, L, a, mp)


def _trilinear(grid, u):
    """Sample grid [N,N,N] at fractional index coords u [..., 3] (periodic),
    the JAX package's loop over the 8 corners."""
    nfft = grid.shape[0]
    i0f = torch.floor(u)
    f = u - i0f
    i0 = i0f.to(torch.int64)
    val = 0.0
    for dx in (0, 1):
        wx = (1.0 - f[..., 0]) if dx == 0 else f[..., 0]
        ix = torch.remainder(i0[..., 0] + dx, nfft)
        for dy in (0, 1):
            wy = (1.0 - f[..., 1]) if dy == 0 else f[..., 1]
            iy = torch.remainder(i0[..., 1] + dy, nfft)
            for dz in (0, 1):
                wz = (1.0 - f[..., 2]) if dz == 0 else f[..., 2]
                iz = torch.remainder(i0[..., 2] + dz, nfft)
                val = val + grid[ix, iy, iz].to(u.dtype) * wx * wy * wz
    return val


def pad_periodic(pot):
    """pot [n, n, n] -> [n+3]^3 with index k holding pot[(k - 1) mod n] on
    each axis: the 4x4x4 block around any trilinear cell lies inside it."""
    return F.pad(pot[None, None], (1, 2, 1, 2, 1, 2),
                 mode="circular")[0, 0].contiguous()


def _block_view(padded):
    """[4, 4, 4, nbase] overlapping view of a padded grid: [:, :, :, b] is
    the 4x4x4 block whose first corner is flat index b."""
    m = padded.shape[0]
    nbase = padded.numel() - 3 * (m * m + m + 1)
    return padded.view(-1).as_strided((4, 4, 4, nbase), (m * m, m, 1, 1))


# corner slices of a 4x4x4 block: the trilinear corners sit at block
# indices 1, 2; a central difference reads them shifted by -1 or +1
_AT = {-1: slice(0, 2), 0: slice(1, 3), 1: slice(2, 4)}
# the (c, d) pairs of the second derivatives, in the JAX package's order
PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _corner_taps(blk, dL, dtype):
    """blk [4, 4, 4, S] (the grid's dtype) -> [10, 2, 2, 2, S] in dtype: at
    the 8 corners, phi, its central first differences along x, y, z and
    its second differences in PAIRS order, each difference formed in the
    grid's dtype and divided in dtype, as JAX's derivative grids are."""
    def at(o):
        return blk[_AT[o[0]], _AT[o[1]], _AT[o[2]]]

    def off(c, s, d=None, t=0):
        o = [0, 0, 0]
        o[c] += s
        if d is not None:
            o[d] += t
        return at(o)

    centre = at((0, 0, 0))
    taps = [centre.to(dtype)]
    for c in range(3):
        taps.append((off(c, 1) - off(c, -1)).to(dtype) / (2.0 * dL))
    for c, d in PAIRS:
        if c == d:
            g = (off(c, 1) + off(c, -1) - 2.0 * centre).to(dtype) / (dL * dL)
        else:
            g = (off(c, 1, d, 1) - off(c, 1, d, -1) - off(c, -1, d, 1)
                 + off(c, -1, d, -1)).to(dtype) / (4.0 * dL * dL)
        taps.append(g)
    return torch.stack(taps)


def path_fields(padded, nfft: int, nhat, rad, L):
    """The ten fields summed along each ray's chord: nhat [3, R] unit
    vectors, rad [nint] sample radii -> [10, R] sums over the samples of
    phi, d phi / dx_c (c = x, y, z) and d2 phi / dx_c dx_d (PAIRS), each
    sampled trilinearly from the central differences of padded (the
    pad_periodic grid), in nhat's dtype."""
    dtype = nhat.dtype
    dL = L / nfft
    m = padded.shape[0]
    view = _block_view(padded)
    nint = rad.shape[0]
    R = nhat.shape[1]
    out = torch.empty((10, R), dtype=dtype, device=nhat.device)
    step = max(1, SAMPLES_PER_CHUNK // nint)
    for a in range(0, R, step):
        b = min(R, a + step)
        pts = nhat[:, a:b, None] * rad[None, None, :]      # [3, r, nint]
        u = torch.remainder(pts, L) / dL - 0.5
        del pts
        i0f = torch.floor(u)
        f = (u - i0f).reshape(3, -1)
        i0 = torch.remainder(i0f.to(torch.int64), nfft).reshape(3, -1)
        del u, i0f
        base = (i0[0] * m + i0[1]) * m + i0[2]
        del i0
        taps = _corner_taps(view[..., base], dL, dtype)   # [10, 2, 2, 2, S]
        del base
        g = 1.0 - f
        w = (torch.stack([g[0], f[0]])[:, None, None]
             * torch.stack([g[1], f[1]])[None, :, None]
             * torch.stack([g[2], f[2]])[None, None, :])  # [2, 2, 2, S]
        vals = (taps * w).sum(dim=(1, 2, 3))               # [10, S]
        out[:, a:b] = vals.view(10, b - a, nint).sum(dim=2)
        del taps, w, vals
    return out


def threedpot_rows(packed, padded, nfft: int, nint: int, L, plane_rad, binL):
    """Integrate phi and its Cartesian derivatives along each ray's radial
    chord through the shell, project, and add to the alpha/U/phi rows of
    packed [21, R] (fftpoissondriver.c:400-1100); returns a new buffer.
    padded is pad_periodic(potential grid); L, plane_rad and binL are
    0-dim tensors in the rays' dtype."""
    dtype = packed.dtype
    dchi = binL / nint
    chimin = plane_rad - binL / 2.0
    rad = chimin + (torch.arange(nint, dtype=dtype, device=packed.device)
                    + 0.5) * dchi
    nx, ny, nz = packed[0], packed[1], packed[2]
    nrm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nhat = packed[0:3] / nrm
    fld = path_fields(padded, nfft, nhat, rad, L)

    # basis Jacobian: cartesian unit vectors on (theta_hat, phi_hat);
    # jac[c][i]: component of x_c on basis vector i (theta, phi)
    theta = torch.arccos(torch.clamp(nhat[2], -1, 1))
    phi = torch.atan2(nhat[1], nhat[0])
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    zero = torch.zeros_like(st)
    jac = ((cp * ct, -sp), (sp * ct, cp), (-st, zero))

    fac1 = 2.0 / CSOL / CSOL * dchi
    out = packed.clone()
    for c in range(3):
        for i in range(2):
            out[14 + i] = out[14 + i] - fac1 * fld[1 + c] * jac[c][i]
    fac2 = 2.0 / CSOL / CSOL * dchi * plane_rad
    uacc = [[0.0, 0.0], [0.0, 0.0]]
    for k, (c, d) in enumerate(PAIRS):
        val = fld[4 + k]
        for i in range(2):
            for j in range(2):
                outer = jac[c][i] * jac[d][j]
                if c != d:
                    outer = outer + jac[d][i] * jac[c][j]
                uacc[i][j] = uacc[i][j] + val * outer
    uacc = [[fac2 * uacc[i][j] for j in range(2)] for i in range(2)]
    # symmetrize the mixed partials (fftpoissondriver.c:1084-1087)
    off = 0.5 * (uacc[0][1] + uacc[1][0])
    out[16] = out[16] + uacc[0][0]
    out[17] = out[17] + off
    out[18] = out[18] + off
    out[19] = out[19] + uacc[1][1]
    out[20] = out[20] + fac1 / plane_rad * fld[0]
    return out


def threedpot_apply_to_rays(rays, pot, nfft: int, nint: int, L, plane_rad,
                            binL):
    """The JAX package's signature on a Rays view (torch tensors): pot is
    the [nfft]^3 potential grid; returns the rays with alpha, U and phi
    updated (threedpot_rows on the packed rays)."""
    from .rays import soa

    packed = soa.pack(rays)

    def s(x):
        return torch.as_tensor(x, dtype=packed.dtype, device=packed.device)

    out = threedpot_rows(packed, pad_periodic(pot), nfft, nint, s(L),
                         s(plane_rad), s(binL))
    return soa.unpack(out)


class ThreeDPotDriver:
    """Per-plane driver with snapshot/grid caching
    (threedpot_poissondriver, fftpoissondriver.c:45-150), on a device: the
    potential grid of the last (snapshot, nfft) and its periodic padding
    stay there until another snapshot or size is asked for.

    On a mesh (parallel/sharding.Mesh) each rank reads and deposits a
    disjoint share of the snapshot's particles (file f on rank f mod n; with
    fewer files than ranks, its block of each file's rows) into a whole
    partial grid of counts, so the periodic wrap needs no care at the slab
    edges; one reduce-scatter sums them onto the ranks' x-slabs, the slab
    solve (potential_from_counts_slab) gives each rank its x rows of the
    potential, and one all-gather makes the grid whole on every rank, as
    the JAX driver holds it, for the rank's ray columns."""

    def __init__(self, cfg, cosmo, device, mesh=None):
        self.cfg = cfg
        self.cosmo = cosmo
        self.device = torch.device(device)
        self.mesh = mesh
        self.length_conv = (cfg.LengthConvFact if cfg.LengthConvFact > 0
                            else 1.0)
        self.snaps = read_snap_list(cfg.ThreeDPotSnapList, cosmo,
                                    self.length_conv)
        self._cached = None  # (snap index, nfft, grid, L, padded grid)
        self.builds = 0
        # the particles this rank deposited for the last grid built
        self.rows_deposited = 0

    def _upload(self, pos):
        """Host float32 positions -> float32 on the device, scaled by
        LengthConvFact in float64 as the JAX package scales them."""
        t = torch.from_numpy(np.ascontiguousarray(pos)).to(self.device)
        if self.length_conv != 1.0:
            t = (t.to(torch.float64) * self.length_conv).to(torch.float32)
        return t

    def grid_for_plane(self, plane_rad, min_sl, phase=default_phase):
        """(grid, L, padded grid) of the snapshot nearest plane_rad, built on
        first use: each file's float32 positions read (PARTIO), uploaded
        (UPLOAD) and deposited (DEPOSIT), then the solve and the padding
        (FFTSOLVE).  On a mesh: this rank's share of the particles, the
        deposits' reduce-scatter (DEPOSIT), the slab solve and the grid's
        all-gather (FFTSOLVE)."""
        from .io import lgadget

        i = nearest_snap(self.snaps, plane_rad)
        s = self.snaps[i]
        nfft = self.cfg.NFFT if self.cfg.NFFT > 0 else choose_nfft(
            s["L"], plane_rad, min_sl, self.cfg.MaxNFFT)
        if self._cached and self._cached[0] == i and self._cached[1] == nfft:
            return self._cached[2:]
        self._cached = None  # the old grids go before the new ones come
        counts = torch.zeros((nfft, nfft, nfft), dtype=torch.float32,
                             device=self.device)
        self.rows_deposited = 0
        for fn, rows in self._my_files(s["fname"]):
            pos, _ = phase("PARTIO", lgadget.read_positions_f32, fn, rows)
            pos_d = phase("UPLOAD", self._upload, pos)
            self.rows_deposited += len(pos)
            del pos
            phase("DEPOSIT", cic_deposit_3d, pos_d, nfft,
                  np.float32(s["L"]), counts)
            del pos_d
        mp = RHO_CRIT * self.cfg.OmegaM * s["L"] ** 3 / s["npart_total"]
        if self.mesh is None:
            grid = phase("FFTSOLVE", potential_from_counts, counts, nfft,
                         s["L"], s["a"], mp)
            del counts
        else:
            counts = phase("DEPOSIT", self.mesh.reduce_scatter_rows, counts)
            slab = phase("FFTSOLVE", potential_from_counts_slab, counts,
                         nfft, s["L"], s["a"], mp, self.mesh)
            del counts
            grid = phase("FFTSOLVE", self.mesh.all_gather_rows, slab,
                         self.mesh.blocks(nfft))
            del slab
        padded = phase("FFTSOLVE", pad_periodic, grid)
        self._cached = (i, nfft, grid, s["L"], padded)
        self.builds += 1
        return self._cached[2:]

    def _my_files(self, fname):
        """[(file, rows)] this rank reads of the snapshot `fname`: every
        file whole on one device; on a mesh of n ranks file f on rank
        f mod n, or, with fewer files than ranks, the rank's block of each
        file's rows ((a, b), Mesh.block of the file's count)."""
        from .io import lgadget

        files = snapshot_files(fname)
        mesh = self.mesh
        if mesh is None:
            return [(fn, None) for fn in files]
        if len(files) >= mesh.size:
            return [(fn, None) for f, fn in enumerate(files)
                    if f % mesh.size == mesh.rank]
        return [(fn, mesh.block(lgadget.read_header(fn)["npart"]))
                for fn in files]

    def nint(self, L, nfft, binL):
        """Samples per ray chord: two per grid cell, at least 4."""
        return max(4, int(binL / (L / nfft) * 2))

    def step(self, packed, scal, born: bool, plane_rad, binL,
             phase=default_phase):
        """One THREEDPOT plane on packed [21, N]: the grid (built or
        cached), then per column chunk of RAY_CHUNK rays the per-plane rows
        zeroed and set from the path integrals (FFTSAMPLE) and the rays
        propagated (RAYPROP) with the beta chord (no radial branch), into a
        new buffer."""
        from .rays import soa

        grid, L, padded = self.grid_for_plane(plane_rad, MIN_SL, phase)
        nfft = grid.shape[0]
        nint = self.nint(L, nfft, binL)

        def s(x):
            count("host_sync")       # a blocking host -> device copy
            return torch.tensor(x, dtype=packed.dtype, device=packed.device)

        Lt, rad_t, binL_t = s(L), s(plane_rad), s(binL)
        N = packed.shape[1]
        out = torch.empty_like(packed)
        for a in range(0, N, RAY_CHUNK):
            b = min(N, a + RAY_CHUNK)
            r = phase("FFTSAMPLE", threedpot_rows,
                      soa.zero_plane_rows(packed[:, a:b]), padded, nfft,
                      nint, Lt, rad_t, binL_t)
            out[:, a:b] = phase("RAYPROP", soa.prop_only_chunk, r, scal.wp,
                                scal.wpm1, scal.wpm2, born)
            del r
        return out


def snapranges_main(argv=None):
    """snapranges3Dpot analog: print '#plane snapshot rmin rmax' for a config
    (reference snapranges3Dpot/main.c:41-70)."""
    import sys

    from .config import read_config
    from .cosmology import Cosmology

    argv = argv if argv is not None else sys.argv[1:]
    cfg = read_config(argv[0])
    cosmo = Cosmology(cfg.OmegaM)
    snaps = read_snap_list(cfg.ThreeDPotSnapList, cosmo,
                           cfg.LengthConvFact if cfg.LengthConvFact > 0 else 1.0)
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    print("#plane snapshot rmin rmax")
    for p in range(cfg.NumLensPlanes):
        i = nearest_snap(snaps, p * binL + binL / 2.0)
        print(f"{p} {snaps[i]['fname']} {p * binL:.3f} {(p + 1) * binL:.3f}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(snapranges_main())
