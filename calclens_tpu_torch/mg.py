"""Batched tangent-patch FAS multigrid refinement (reference
mgpoissonsolve.c / mgpoissonsolve_utils.c).

Port of calclens_tpu/mg.py.  Every active bundle cell gets a theta-phi
patch rotated so its center sits on the equator; the patch geometry then
depends only on the patch size, so every per-row metric vector (the finite
volume sin factors, cell solid angles, diagonal) is shared across cells and
all patches solve together as [C, N, N] tensors.

Discretization (finite volume on the spherical patch, mgpoissonsolve_utils.c
alloc_mggrid + smooth_mggrid):
  L(u)[i,j] = [ s_{i-1/2} u[i-1,j] + s_{i+1/2} u[i+1,j]
              + (u[i,j-1] + u[i,j+1]) / s_i  - diag_i u[i,j] ] / (h^2 s_i)
  diag_i = s_{i-1/2} + s_{i+1/2} + 2 / s_i,   s = sin(theta)
with a Dirichlet ghost ring carrying boundary values interpolated from the
spherical-harmonic potential map (fill_bcs_mggrid).  Smoother: column-parity
red-black Gauss-Seidel (REDBLACK branch); cycles: FAS V-cycles, a fixed
count or the reference's truncation-error stopping rule.

The JAX package's compiled loops (fori_loop, while_loop) are Python loops
here, and the stencils read shifted slices of the interior instead of
rolled copies of the whole grid: the ghost ring is masked out of every
update, so the two are the same function.  The adaptive solve reads its
stopping test on the host once per cycle (its only device sync).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .utils.profile import count

MGPATCH_SIZE_FAC = 4.0       # reference raytrace.h:125
NUM_MGPATCH_MIN = 256        # reference raytrace.h:126


def patch_interior_sizes(n_fine):
    """Level interior sizes n, n/2, ... while even, ending in {4,5,7,9}-ish
    (reference level choice from {4,5,7,9}*2^k, mgpoissonsolve.c:151-174)."""
    sizes = [n_fine]
    n = n_fine
    while n % 2 == 0 and n // 2 >= 4:
        n //= 2
        sizes.append(n)
    return sizes


def choose_patch_n(L, min_sl, n_min=NUM_MGPATCH_MIN, n_max=1024):
    """Fine-grid size ~ patch length / (min smoothing / 2), rounded to a
    power-of-two-times-{4,5,7,9} (raytrace.c:485-498)."""
    want = max(n_min, int(L / (min_sl / 2.0)))
    best, bestd = None, None
    for base in (4, 5, 7, 9):
        k = int(np.ceil(np.log2(max(1.0, want / base))))
        for dk in (-1, 0, 1):
            n = base * 2 ** max(k + dk, 0)
            d = abs(n - want)
            if (bestd is None or d < bestd) and n <= n_max:
                best, bestd = n, d
    return best


@dataclass(frozen=True)
class PatchLevel:
    """Geometry of one level: interior n, total N = n+2 (ghost ring)."""

    n: int
    N: int
    dL: float
    thetaLoc: float
    phiLoc: float
    sin_half: tuple    # (s_{i-1/2} [N], s_{i+1/2} [N]) flattened
    sin_c: tuple       # s_i at centers [N]
    cosfacs: tuple     # cell delta-cos (solid angle / dL) [N]
    diag: tuple        # [N]


def build_levels(L, n_fine):
    """Geometry for every level of a patch of angular size L (radians)."""
    levels = []
    for n in patch_interior_sizes(n_fine):
        N = n + 2
        dL = L / n
        Lg = L + 2 * dL
        thetaLoc = np.pi / 2 - Lg / 2 + dL / 2
        phiLoc = -Lg / 2 + dL / 2
        i = np.arange(N)
        th = i * dL + thetaLoc
        sin_c = np.sin(th)
        sin_m = np.sin(th - dL / 2)          # s_{i-1/2}
        sin_p = np.sin(th + dL / 2)          # s_{i+1/2}
        cosfacs = np.cos(th - dL / 2) - np.cos(th + dL / 2)
        diag = sin_m + sin_p + 2.0 / sin_c
        levels.append(PatchLevel(
            n=n, N=N, dL=float(dL), thetaLoc=float(thetaLoc),
            phiLoc=float(phiLoc),
            sin_half=tuple(np.stack([sin_m, sin_p]).ravel()),
            sin_c=tuple(sin_c), cosfacs=tuple(cosfacs), diag=tuple(diag)))
    return levels


# per (level, dtype, device) tables, built once: a host -> device copy
# inside the cycle loop would wait for the queued work
_TABLES = {}


def _tables(lev, dtype, device):
    """Interior rows [n, 1] of s_{i-1/2}, s_{i+1/2}, s_i, diag_i and the
    red and black masks [n, n] of the interior."""
    key = (lev, dtype, str(device))
    if key not in _TABLES:
        sh = np.asarray(lev.sin_half).reshape(2, lev.N)
        i = np.arange(1, lev.N - 1)
        red = (i[:, None] + i[None, :]) % 2 == 0

        def dev(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        _TABLES[key] = tuple(
            dev(v[1:-1])[:, None]
            for v in (sh[0], sh[1], np.asarray(lev.sin_c),
                      np.asarray(lev.diag))) + (dev(red), dev(~red))
    return _TABLES[key]


def _neighbour_sum(u, sm, sp, sc):
    """s_{i-1/2} u[i-1,j] + s_{i+1/2} u[i+1,j] + (u[i,j-1] + u[i,j+1]) / s_i
    on the interior [..., n, n]."""
    return (sm * u[..., :-2, 1:-1] + sp * u[..., 2:, 1:-1]
            + (u[..., 1:-1, :-2] + u[..., 1:-1, 2:]) / sc)


def lop(u, lev):
    """Apply the FV spherical Laplacian to interior cells; ghost ring -> 0."""
    sm, sp, sc, diag, _, _ = _tables(lev, u.dtype, u.device)
    h2 = lev.dL * lev.dL
    out = torch.zeros_like(u)
    out[..., 1:-1, 1:-1] = ((_neighbour_sum(u, sm, sp, sc)
                             - diag * u[..., 1:-1, 1:-1]) / (h2 * sc))
    return out


def _interior_mask(lev, dtype, device):
    key = (lev, dtype, str(device), "mask")
    if key not in _TABLES:
        i = np.arange(lev.N)
        m = (i > 0) & (i < lev.N - 1)
        _TABLES[key] = torch.as_tensor(np.outer(m, m), dtype=dtype,
                                       device=device)
    return _TABLES[key]


def _rbgs_(u, rhs, lev, nsweeps: int):
    """rbgs in place on u."""
    sm, sp, sc, diag, red, black = _tables(lev, u.dtype, u.device)
    h2sc = (lev.dL * lev.dL) * sc
    ui = u[..., 1:-1, 1:-1]
    ri = rhs[..., 1:-1, 1:-1]
    for _ in range(nsweeps):
        for color in (red, black):
            new = (_neighbour_sum(u, sm, sp, sc) - h2sc * ri) / diag
            ui.add_(color * (new - ui))
            del new
    return u


def rbgs(u, rhs, lev, nsweeps: int):
    """Column-parity red-black Gauss-Seidel (REDBLACK smoother): nsweeps
    sweeps of the red then the black interior cells.  Returns a new
    tensor; u is left as it was."""
    return _rbgs_(u.clone(), rhs, lev, nsweeps)


def restrict_full(x):
    """Cell-centered 2x2 average of the interior; ghost ring of the coarse
    grid copies the nearest fine ghost values (2:1 average along the
    edge)."""
    inner = x[..., 1:-1, 1:-1]
    c = 0.25 * (inner[..., 0::2, 0::2] + inner[..., 1::2, 0::2]
                + inner[..., 0::2, 1::2] + inner[..., 1::2, 1::2])
    Nc = c.shape[-1] + 2
    out = torch.zeros(x.shape[:-2] + (Nc, Nc), dtype=x.dtype,
                      device=x.device)
    out[..., 1:-1, 1:-1] = c

    def edge(sl):
        return 0.5 * (sl[..., 0::2] + sl[..., 1::2])

    out[..., 0, 1:-1] = edge(x[..., 0, 1:-1])
    out[..., -1, 1:-1] = edge(x[..., -1, 1:-1])
    out[..., 1:-1, 0] = edge(x[..., 1:-1, 0])
    out[..., 1:-1, -1] = edge(x[..., 1:-1, -1])
    return out


def _prolong_add_(u_f, corr_c):
    """prolong_add in place on u_f."""
    c = corr_c[..., 1:-1, 1:-1]
    nc = c.shape[-1]
    # pad with zeros (correction -> 0 at the boundary)
    cp = torch.nn.functional.pad(c, (1, 1, 1, 1))
    # fine cell (2i+a, 2j+b), a,b in {0,1}: weights 9/16, 3/16, 3/16, 1/16
    w1, w3, w9 = 1.0 / 16, 3.0 / 16, 9.0 / 16

    def shift(dx, dy):
        return cp[..., 1 + dx: 1 + dx + nc, 1 + dy: 1 + dy + nc]

    base = shift(0, 0)
    fine = u_f[..., 1:-1, 1:-1]
    for a, sx in ((0, -1), (1, 1)):
        for b, sy in ((0, -1), (1, 1)):
            fine[..., a::2, b::2] += (w9 * base + w3 * shift(sx, 0)
                                      + w3 * shift(0, sy)
                                      + w1 * shift(sx, sy))
    return u_f


def prolong_add(u_f, corr_c):
    """Bilinear prolongation of the coarse correction added to the fine grid
    (interior only; corrections vanish at the Dirichlet boundary).
    Returns a new tensor."""
    return _prolong_add_(u_f.clone(), corr_c)


def _vcycle_(u, rhs, levels, li: int, npre: int, npost: int):
    """vcycle in place on u."""
    lev = levels[li]
    _rbgs_(u, rhs, lev, npre)
    if li + 1 < len(levels):
        levc = levels[li + 1]
        uc0 = restrict_full(u)
        resid = rhs - lop(u, lev)
        resid *= _interior_mask(lev, u.dtype, u.device)
        rhs_c = lop(uc0, levc)
        rhs_c += restrict_full(resid)
        del resid
        uc = _vcycle_(uc0.clone(), rhs_c, levels, li + 1, npre, npost)
        del rhs_c
        uc -= uc0
        del uc0
        _prolong_add_(u, uc)
        del uc
    else:
        _rbgs_(u, rhs, lev, 32)
    return _rbgs_(u, rhs, lev, npost)


def vcycle(u, rhs, levels, li: int, npre: int, npost: int):
    """One FAS V-cycle starting at level index li (0 = finest).  Returns a
    new tensor."""
    return _vcycle_(u.clone(), rhs, levels, li, npre, npost)


def solve_fas(u0, rhs, levels: tuple, ncycles: int = 8, npre: int = 2,
              npost: int = 2):
    """Batched FAS solve: u0, rhs [C, N, N] with Dirichlet values in u0's
    ghost ring.  Returns u with the same ghost ring."""
    u = u0.clone()
    for _ in range(ncycles):
        _vcycle_(u, rhs, levels, 0, npre, npost)
    return u


def _truncation_norm(u, rhs, levels):
    """FAS truncation-error estimate tau = L_c(R u) - R(L_f u) per patch
    (the reference's relative convergence reference, mgpoissonsolve_utils.c
    solve_fas_mggrid): returns its L1 norm over each patch [C]."""
    lev, levc = levels[0], levels[1]
    tau = lop(restrict_full(u), levc) - restrict_full(
        lop(u, lev) * _interior_mask(lev, u.dtype, u.device))
    return torch.sum(torch.abs(tau), dim=(-2, -1))


def solve_fas_adaptive(u0, rhs, levels: tuple, conv_fact,
                       max_cycles: int = 20, npre: int = 2, npost: int = 2,
                       agree=None):
    """FAS solve with the reference's truncation-error-relative stopping
    rule (MGConvFact, mgpoissonsolve_utils.c:44-192): V-cycle until every
    patch's residual L1 norm is below conv_fact times its truncation-error
    estimate, capped at max_cycles.  A single-level hierarchy cycles
    max_cycles times.  Returns (u, cycles taken); the test runs on the
    host before each cycle.  agree(flag) turns this batch's flag (a bool
    tensor) into the host decision: on a mesh, Mesh.all_true, so the test
    covers every rank's patches, as JAX's jnp.all covers every patch, and
    every rank takes the one-device count of cycles."""
    if len(levels) < 2:
        return solve_fas(u0, rhs, levels, max_cycles, npre, npost), max_cycles
    lev = levels[0]
    mask = _interior_mask(lev, u0.dtype, u0.device)
    u = u0.clone()
    k = 0
    while k < max_cycles:
        taun = _truncation_norm(u, rhs, levels)
        res = torch.sum(torch.abs((rhs - lop(u, lev)) * mask), dim=(-2, -1))
        # patches with zero source (tau ~ 0) are converged by definition
        done = torch.all(res <= conv_fact * torch.clamp(taun, min=1e-300))
        count("host_sync")     # the stopping test waits for the card
        if agree(done) if agree is not None else bool(done):
            break
        _vcycle_(u, rhs, levels, 0, npre, npost)
        k += 1
    return u, k
