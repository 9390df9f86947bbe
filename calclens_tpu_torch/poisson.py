"""Spherical Poisson solve and the per-plane step (reference
shtpoissonsolve.c + poissondrivers.c), full sky, SHT only, NGP deposit.

Port of calclens_tpu/poisson.py.  Per lens plane: particles -> NGP deposit
onto the poissonOrder RING map -> scale by densfact/pixarea and subtract the
background -> map2alm -> alm *= -1/(l(l+1)) (monopole zeroed) -> alm2allmaps
(phi + 5 covariant derivatives) -> bilinear + parallel-transport
interpolation onto the rays (alpha -= grad phi, U += hess phi) -> geodesic
propagation to the next plane, as four phase_* calls.  Eager torch: each
stage runs as it is called; temporaries are dropped as soon as the next
stage has its input.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .ops import deposit as dep
from .ops.interp import FieldMaps
from .rays import soa
from .sht import transforms as T
from .sht.plan import SHTPlan

# column chunk of the ray side: bounds its transient working set
RAY_CHUNK = 1 << 24


class PlaneScalars(NamedTuple):
    """Per-plane scalars (set_plane_params outputs, raytrace.c:384-500) as
    0-d tensors in the working dtype on the plane's device."""

    densfact: torch.Tensor
    backdens: torch.Tensor
    wp: torch.Tensor      # next plane radius (propagation target)
    wpm1: torch.Tensor    # current plane radius
    wpm2: torch.Tensor    # previous plane radius


def plane_scalars(pp, dtype, device) -> PlaneScalars:
    """driver.PlaneParams -> PlaneScalars."""
    def s(x):
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

def phase_deposit(plan: SHTPlan, pos, mass, scheme: str, scal: PlaneScalars):
    """Particles -> scaled surface-density map [npix] (DEPOSIT)."""
    if scheme == "CIC":
        raise NotImplementedError("calclens_tpu_torch does not run "
                                  "DepositScheme CIC yet: it arrives with "
                                  "ROADMAP Queue 1, slice 6")
    if scheme == "SPH":
        raise NotImplementedError("calclens_tpu_torch does not run "
                                  "DepositScheme SPH yet: it arrives with "
                                  "ROADMAP Queue 1, slice 7")
    pixarea = 4.0 * math.pi / plan.npix
    density = dep.deposit_ngp(plan.order, pos, mass, plan.npix)
    return dep.scale_density(density, scal.densfact, scal.backdens, pixarea)


def phase_analysis(plan: SHTPlan, density):
    """density -> Poisson-filtered alm (SHTSOLVE: map2alm + -1/l(l+1))."""
    return _poisson_filter(plan, T.map2alm(plan, density))


def phase_synthesis(plan: SHTPlan, alm):
    """alm -> the six field maps stacked [6, npix] (SHT: alm2allmaps)."""
    return T.alm2allmaps(plan, alm)


def phase_rayside(tab, packed, maps, scal: PlaneScalars, born: bool):
    """Zero the per-plane rows, interpolate the stacked maps to the rays
    and propagate (INTERP + RAYPROP), on the packed buffer in column
    chunks with the global gather from the whole maps."""
    def block(b):
        return soa.interp_and_prop_chunk(tab, maps, b, scal.wp, scal.wpm1,
                                         scal.wpm2, born)

    return soa.chunked(block, soa.zero_plane_rows(packed), RAY_CHUNK)


def _call(tag, fn, *args):
    return fn(*args)


def plane_step_packed(plan: SHTPlan, tab, packed, pos, mass, born: bool,
                      with_maps: bool, scal: PlaneScalars, scheme="NGP",
                      phase=_call):
    """One lens-plane step on the packed ray buffer: deposit, SHT Poisson
    solve, interpolation to the rays, propagation to the next plane (the
    four phase_* calls, each made as phase(tag, fn, *args): a plain call by
    default, a timed one in the driver's Profile mode).  Returns (packed',
    FieldMaps or None)."""
    density = phase("DEPOSIT", phase_deposit, plan, pos, mass, scheme, scal)
    alm = phase("SHTSOLVE", phase_analysis, plan, density)
    del density
    maps = phase("SHT", phase_synthesis, plan, alm)
    del alm
    packed = phase("RAYPROP", phase_rayside, tab, packed, maps, scal, born)
    return packed, (FieldMaps(*maps.unbind(0)) if with_maps else None)


def empty_plane_step_packed(born: bool, packed, scal: PlaneScalars,
                            radial: bool = False):
    """Particle-free plane: zero the per-plane rows and propagate.  radial=True takes the reference's alpha == 0 rayprop branch
    (radial position rescale, rayprop.c:125-131); the default keeps the beta
    chord."""
    packed = soa.zero_plane_rows(packed)
    return soa.chunked(
        lambda b: soa.prop_only_chunk(b, scal.wp, scal.wpm1, scal.wpm2, born,
                                      radial_when_straight=radial),
        packed, RAY_CHUNK)
