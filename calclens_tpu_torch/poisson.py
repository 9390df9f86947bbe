"""Spherical Poisson solve and the per-plane step (reference
shtpoissonsolve.c + poissondrivers.c).

Port of calclens_tpu/poisson.py.  Per lens plane: particles -> NGP, CIC or
sigma-bucketed SPH deposit onto the poissonOrder RING map (or a precomputed
mass map) -> scale by densfact/pixarea and subtract the background (cut
sky: vacuum pixels zeroed) -> map2alm (SPH: one per bucket, times its
kernel window) -> alm *= -1/(l(l+1)) (monopole zeroed) -> alm2allmaps (phi
+ 5 covariant derivatives) -> bilinear + parallel-transport interpolation
onto the rays (alpha -= grad phi, U += hess phi) -> geodesic propagation to
the next plane, as four phase_* calls.  Eager torch: each stage runs as it
is called; temporaries are dropped as soon as the next stage has its input.
plane_step_mg is the non-SHTONLY step: the SHT gives the potential map
alone and the multigrid patches (mgdriver.py) give the rays their fields.

On a mesh (plan.mesh, parallel/sharding.py) the SHT-only steps run
sharded: each rank deposits its particle rows into a whole map, the maps
are summed onto the ranks' pixel blocks by one reduce-scatter and scaled
there, the transforms run sharded (sht/transforms.py), and each rank's rays
read the field maps through a halo exchange (parallel/halo.py) when the
rays are the full sky's in RING order, else from the maps gathered whole.
plane_step_mg on a mesh runs the same sharded deposit and transforms, the
potential map gathered whole on every rank, then the sharded multigrid
refinement (mgdriver.mg_refine's mesh) for the rank's ray columns.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .ops import deposit as dep
from .ops.interp import FieldMaps
from .rays import soa
from .sht import transforms as T
from .sht.plan import SHTPlan
from .utils.profile import count
from .utils.profile import phase as default_phase

# column chunk of the multigrid and THREEDPOT ray sides: bounds their
# transient working sets
RAY_CHUNK = 1 << 24
# column chunk of the plain SHT-only ray side (phase_rayside's CPU twin,
# the empty plane): its interpolation and propagation hold ~290 floats per
# ray at their peak, 18 GiB at 2^24 rays (the peak of the order-13 step on
# an H100 before the ray-side kernel; chip_smoke.py phase 15, PERF.md)
RAYSIDE_CHUNK = 1 << 22


class PlaneScalars(NamedTuple):
    """Per-plane scalars (set_plane_params outputs, raytrace.c:384-500) as
    0-d tensors in the working dtype on the plane's device."""

    densfact: torch.Tensor
    backdens: torch.Tensor
    wp: torch.Tensor      # next plane radius (propagation target)
    wpm1: torch.Tensor    # current plane radius
    wpm2: torch.Tensor    # previous plane radius


def plane_scalars(pp, dtype, device) -> PlaneScalars:
    """driver.PlaneParams -> PlaneScalars (each a blocking host -> device
    copy on the card)."""
    def s(x):
        count("host_sync")
        return torch.tensor(x, dtype=dtype, device=device)

    return PlaneScalars(densfact=s(pp.densfact), backdens=s(pp.backdens),
                        wp=s(pp.rad_plus1), wpm1=s(pp.rad),
                        wpm2=s(pp.rad_minus1))


def _poisson_filter(plan: SHTPlan, alm):
    """alm *= -1/(l(l+1)) (monopole zeroed), times the plan's window."""
    ls = torch.arange(plan.nl, dtype=plan.dtype, device=alm.device)[:, None]
    inv = torch.where(ls > 0, -1.0 / torch.clamp(ls * (ls + 1.0), min=1.0),
                      0.0)
    if plan.window_dev is not None:
        inv = inv * plan.window_dev[:, None]
    return alm * inv.to(plan.dtype)


# ----------------------------------------------------------------------------
# the plane step cut at the reference's phase boundaries (calclens_tpu/
# poisson.py phase_*): the driver's Profile mode times each phase with a
# device sync between them (profile.c tags; shtpoissonsolve.c:521-576), and
# the fused step is the same four calls without the syncs
# ----------------------------------------------------------------------------

def phase_deposit(plan: SHTPlan, tab, pos, mass, scheme: str,
                  scal: PlaneScalars, vacmask=None, sph=None):
    """Particles -> scaled surface-density map (DEPOSIT).

    scheme "SPH" returns the sigma-bucketed [B, npix] maps for
    phase_analysis_sph (sph: the driver's tuple (sigmas..., csl, min_sl,
    max_sl)); NGP and CIC return the flat [npix] map.  vacmask [npix] bool
    marks the cut-sky vacuum pixels, which are zeroed.  On a mesh pos and
    mass are this rank's particle rows, and the result is this rank's block
    of pixels: the unscaled deposits are summed over the ranks by one
    reduce-scatter (the JAX psum_scatter), then scaled on the block."""
    pixarea = 4.0 * math.pi / plan.npix
    mesh = plan.mesh
    if mesh is not None and vacmask is not None:
        a, b = mesh.block(plan.npix)
        vacmask = vacmask[a:b]
    if scheme == "SPH":
        *sigmas, csl, min_sl, max_sl = sph
        sl = dep.smoothing_lengths(pos, csl, min_sl, max_sl)
        dens_b = dep.deposit_sph_bucketed(plan.order, pos, mass, sl, sigmas,
                                          plan.npix, tab=tab)
        if mesh is not None:
            dens_b = mesh.reduce_scatter_blocks(dens_b)
        # in place: the buckets are 8 maps (6.4 GB at order 12); backdens is
        # a monopole shift (zeroed by the filter) except in cut-sky mode,
        # where bucket 0 carries it on the live pixels
        dens_b.mul_(scal.densfact / pixarea * dep.MASS_SCALE)
        if vacmask is not None:
            dens_b.masked_fill_(vacmask, 0.0)
            dens_b[0].sub_(torch.where(vacmask, 0.0, scal.backdens))
        return dens_b
    if scheme == "CIC":
        density = dep.deposit_cic(tab, pos, mass)
    elif scheme == "NGP":
        density = dep.deposit_ngp(plan.order, pos, mass, plan.npix)
    else:
        raise ValueError(f"deposit scheme {scheme!r}")
    if mesh is not None:
        density = mesh.reduce_scatter_blocks(density)
    return dep.scale_density(density, scal.densfact, scal.backdens, pixarea,
                             vacmask)


def phase_analysis(plan: SHTPlan, density):
    """density -> Poisson-filtered alm (SHTSOLVE: map2alm + -1/l(l+1))."""
    return _poisson_filter(plan, T.map2alm(plan, density))


def sph_windows(plan: SHTPlan, sigmas):
    """[B, nl] per-bucket windows: each bucket's kernel window over the
    squared CIC assignment window, kernel_bl(sigma_b) / pixwin^2, in the
    plan's dtype on its device.  Built on the host once per plan and sigma
    grid (the JAX package rebuilds them every plane)."""
    def build():
        w2 = dep.pixwin_disc_bl(plan.order, plan.lmax) ** 2
        return torch.as_tensor(
            np.stack([dep.kernel_bl(float(s), plan.lmax) / w2
                      for s in sigmas]), dtype=plan.dtype, device=plan.device)

    return plan.tables.get(("sph_windows", tuple(map(float, sigmas))), build)


def phase_analysis_sph(plan: SHTPlan, dens_b, sigmas):
    """Bucketed [B, npix] maps -> Poisson-filtered alm (SHTSOLVE, SPH form:
    per-bucket map2alm times its window, summed).  One transform at a time,
    so the peak is one transform's working set above the buckets."""
    windows = sph_windows(plan, sigmas)
    alm = None
    for b in range(len(sigmas)):
        a = T.map2alm(plan, dens_b[b]) * windows[b][:, None]
        alm = a if alm is None else alm.add_(a)
        del a
    return _poisson_filter(plan, alm)


def phase_synthesis(plan: SHTPlan, alm):
    """alm -> [7, npix]: the six field maps (SHT: alm2allmaps, streamed
    over j-blocks where transforms.synth_stream_blocks says so) written
    into rows 0-5, and row 6 the pixel ids the ray side's gathers return
    (soa.pixel_id_row), made once per plane.  On a mesh: this rank's block
    [6, b - a] of the six maps (the ray side adds the ids of its window)."""
    if plan.mesh is not None:
        return T.alm2allmaps(plan, alm)
    out = torch.empty((7, plan.npix), dtype=plan.dtype, device=alm.device)
    out[6] = soa.pixel_id_row(plan.npix, plan.dtype, alm.device)
    T.alm2allmaps(plan, alm, out=out[:6])
    return out


def phase_rayside(tab, packed, maps7, scal: PlaneScalars, born: bool):
    """Interpolate the maps to the rays and propagate (INTERP + RAYPROP)
    with the global gather from the whole maps ([7, npix] from
    phase_synthesis), into a new [21, N] buffer; packed is left as it
    was (soa.interp_and_prop: one kernel launch on the card, the plain
    twin in column chunks of RAYSIDE_CHUNK on the CPU)."""
    return soa.interp_and_prop(tab, maps7, packed, scal.wp, scal.wpm1,
                               scal.wpm2, born, chunk=RAYSIDE_CHUNK)


def phase_rayside_mesh(plan: SHTPlan, tab, packed, maps, scal: PlaneScalars,
                       born: bool, halo=None):
    """phase_rayside on a mesh: packed [21, c] this rank's ray columns,
    maps [6, b - a] its pixel block.  With halo (full-sky rays in RING
    order, parallel/halo.required_halo) the rays read the window of the
    maps around the block (halo.interp_and_prop_sharded); otherwise the
    maps are gathered whole on every rank first (what GSPMD does in the
    JAX package's other branch)."""
    from .parallel import halo as halo_mod

    if halo is not None:
        return halo_mod.interp_and_prop_sharded(
            tab, maps[:6], packed, scal.wp, scal.wpm1, scal.wpm2, born,
            plan.mesh, halo, RAYSIDE_CHUNK)
    full = plan.mesh.all_gather_cols(maps[:6], plan.pix_bounds)
    maps7 = soa.with_pixel_ids(full)
    del full
    return phase_rayside(tab, packed, maps7, scal, born)


def _rayside(plan, tab, packed, maps, scal, born, halo, phase):
    if plan.mesh is not None:
        return phase("RAYPROP", phase_rayside_mesh, plan, tab, packed, maps,
                     scal, born, halo)
    return phase("RAYPROP", phase_rayside, tab, packed, maps, scal, born)


def plane_step_packed(plan: SHTPlan, tab, packed, pos, mass, born: bool,
                      with_maps: bool, scal: PlaneScalars, scheme="NGP",
                      vacmask=None, sph=None, phase=default_phase,
                      halo=None):
    """One lens-plane step on the packed ray buffer: deposit, SHT Poisson
    solve, interpolation to the rays, propagation to the next plane (the
    four phase_* calls, each made as phase(tag, fn, *args): inside the
    span of its tag by default (utils/profile.phase), a timed one in the
    driver's Profile mode).  Returns (packed',
    FieldMaps or None).  On a mesh (plan.mesh): packed, pos and mass are
    this rank's columns and rows, the FieldMaps its pixel blocks, and halo
    the ray side's halo (phase_rayside_mesh)."""
    density = phase("DEPOSIT", phase_deposit, plan, tab, pos, mass, scheme,
                    scal, vacmask, sph)
    if scheme == "SPH":
        alm = phase("SHTSOLVE", phase_analysis_sph, plan, density, sph[:-3])
    else:
        alm = phase("SHTSOLVE", phase_analysis, plan, density)
    del density
    maps = phase("SHT", phase_synthesis, plan, alm)
    del alm
    packed = _rayside(plan, tab, packed, maps, scal, born, halo, phase)
    return packed, (FieldMaps(*maps[:6].unbind(0)) if with_maps else None)


def plane_step_density_packed(plan: SHTPlan, tab, packed, density,
                              born: bool, with_maps: bool,
                              scal: PlaneScalars, vacmask=None,
                              phase=default_phase, halo=None):
    """plane_step_packed from a precomputed map (the UseHEALPixLensPlaneMaps
    path, shtpoissonsolve.c:336-436): density [npix] is mass per pixel /
    MASS_SCALE in RING order; its scaling is the DEPOSIT phase.  On a mesh
    density is this rank's pixel block (and vacmask the whole mask)."""
    if plan.mesh is not None and vacmask is not None:
        a, b = plan.mesh.block(plan.npix)
        vacmask = vacmask[a:b]
    density = phase("DEPOSIT", dep.scale_density, density, scal.densfact,
                    scal.backdens, 4.0 * math.pi / plan.npix, vacmask)
    alm = phase("SHTSOLVE", phase_analysis, plan, density)
    del density
    maps = phase("SHT", phase_synthesis, plan, alm)
    del alm
    packed = _rayside(plan, tab, packed, maps, scal, born, halo, phase)
    return packed, (FieldMaps(*maps[:6].unbind(0)) if with_maps else None)


def potential_map(plan: SHTPlan, alm):
    """alm -> the whole RING potential map (alm2map: K2's 4-column form);
    on a mesh the rank's alm columns -> its pixel block, gathered whole on
    every rank (the JAX package keeps the map replicated)."""
    potmap = T.alm2map(plan, alm)
    if plan.mesh is None:
        return potmap
    return plan.mesh.all_gather_cols(potmap, plan.pix_bounds)


def plane_step_mg(plan: SHTPlan, tab, mgsetup, packed, pos, mass,
                  scheme: str, born: bool, scal: PlaneScalars, vacmask=None,
                  conv_fact: float = -1.0, sph=None, ray_nest=None,
                  phase=default_phase, col0=0):
    """Non-SHTONLY plane step (reference poissondrivers.c:14-80 +
    mgpoissonsolve.c): the SHT solve gives the long-range potential MAP
    only (the NGP map deposit, CIC under scheme "CIC"; map2alm, the
    filter, alm2map: K1 and K2's 4-column form), then the batched
    tangent-patch multigrid refinement (mgdriver.mg_refine; the patch
    deposit is CIC, spline-smoothed under scheme "SPH") gives the rays
    their deflection and shear from finite differences of the patch
    potential, and the rays propagate.  ray_nest: None for full-sky rays in
    RING order, else each ray's NEST pixel (int64, on the rays' device).

    The ray side runs in column chunks of RAY_CHUNK: each chunk of the
    input is copied, its per-plane rows zeroed and set from the patches
    (MGINTERP), propagated (RAYPROP) and written into a new buffer, so the
    input is left as it was.  Each part is made as phase(tag, fn, *args):
    DEPOSIT, SHTSOLVE, SHT, MGDEPOSIT, MGBC, MGSOLVE, then MGINTERP and
    RAYPROP per chunk.  Returns (packed', V-cycles of the patch solve).

    On a mesh (plan.mesh): packed, pos and mass are this rank's columns and
    rows, ray_nest the NEST pixels of its columns (or col0 its first
    column, for full-sky rays); the map deposit reduce-scatters, the
    transforms run on the rank's m rows, the potential map is gathered
    whole (SHT) and the patch solve is sharded (mgdriver.mg_refine)."""
    from . import mgdriver

    density = phase("DEPOSIT", phase_deposit, plan, tab, pos, mass,
                    "CIC" if scheme == "CIC" else "NGP", scal, vacmask)
    alm = phase("SHTSOLVE", phase_analysis, plan, density)
    del density
    potmap = phase("SHT", potential_map, plan, alm)
    del alm
    sl = None
    if scheme == "SPH" and sph is not None:
        sl = dep.smoothing_lengths(pos, *sph[-3:])
    field, cycles = mgdriver.mg_refine(
        mgsetup, tab, lambda a, b: packed[0:3, a:b], ray_nest,
        mgsetup.ray_order, potmap, pos, mass, scal.densfact, scal.backdens,
        conv_fact=conv_fact, sl=sl, phase=phase, mesh=plan.mesh, col0=col0)
    del potmap

    def interp(a, b):
        r = packed[:, a:b].clone()
        r[14:21] = 0.0
        pot, g0, g1, h00, h01, h10, h11 = field(a, b)
        # phi = pot, alpha -= grad, U += hess (mgpoissonsolve.c:1150-1346)
        r[20] = pot
        r[14] -= g0
        r[15] -= g1
        r[16] += h00
        r[17] += h01
        r[18] += h10
        r[19] += h11
        return r

    N = packed.shape[1]
    out = torch.empty_like(packed)
    for a in range(0, N, RAY_CHUNK):
        b = min(N, a + RAY_CHUNK)
        r = phase("MGINTERP", interp, a, b)
        out[:, a:b] = phase("RAYPROP", soa.prop_only_chunk, r, scal.wp,
                            scal.wpm1, scal.wpm2, born)
        del r
    return out, cycles


def empty_plane_step_packed(born: bool, packed, scal: PlaneScalars,
                            radial: bool = False):
    """Particle-free plane: zero the per-plane rows and propagate.  radial=True takes the reference's alpha == 0 rayprop branch
    (radial position rescale, rayprop.c:125-131); the default keeps the beta
    chord."""
    return soa.chunked_into(
        lambda b: soa.prop_only_chunk(b, scal.wp, scal.wpm1, scal.wpm2, born,
                                      radial_when_straight=radial),
        packed, RAYSIDE_CHUNK)
