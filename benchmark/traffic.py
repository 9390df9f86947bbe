"""The one generator of lens-plane traffic: a mix file's parameters ->
the particle planes a cell stages on the device, from the run's seed.

A mix file (benchmark/traffic/<name>.json) gives, per plane:

    particles      particles in the plane
    chi, shell     the shell's centre and thickness (Mpc/h)
    clump_share    the share of the particles in Gaussian clumps
    clumps         the number of clumps, placed uniformly in the shell
    clump_sigma    each clump's 3-D Gaussian width (Mpc/h)
    staged_planes  the distinct planes staged on the device (>= 2)

The uniform particles take uniform directions and radii uniform in volume
within the shell; the clumped ones a clump's centre plus a Gaussian offset.
Every seed gives the same counts and sizes, in another arrangement.  Each
particle carries the mean matter mass of the plane being stepped over the
count (plane_mass: OmegaM rho_crit times the plane's shell volume), so
every plane has a lightcone shell's density contrast; the deposit (NGP)
reads the particles' directions only, so the staged radii serve every
plane.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 24  # particles drawn per call: bounds the generator's temporaries


def _shell_points(gen, n, chi, shell, device):
    """n float32 points uniform in the shell chi +- shell / 2."""
    v = torch.randn((n, 3), generator=gen, device=device, dtype=torch.float32)
    v /= torch.linalg.vector_norm(v, dim=1, keepdim=True)
    r0, r1 = chi - shell / 2.0, chi + shell / 2.0
    u = torch.rand((n, 1), generator=gen, device=device, dtype=torch.float32)
    r = (r0 ** 3 + u * (r1 ** 3 - r0 ** 3)) ** (1.0 / 3.0)
    return v * r


def plane(gen, mix, device):
    """One plane's (pos [n, 3], mass [n]) float32 on device; the masses
    are set per plane (plane_mass)."""
    n = int(mix["particles"])
    nc = int(n * float(mix.get("clump_share", 0.0)))
    pos = torch.empty((n, 3), dtype=torch.float32, device=device)
    for a in range(nc, n, CHUNK):
        b = min(n, a + CHUNK)
        pos[a:b] = _shell_points(gen, b - a, mix["chi"], mix["shell"], device)
    if nc:
        centres = _shell_points(gen, int(mix["clumps"]), mix["chi"],
                                mix["shell"], device)
        for a in range(0, nc, CHUNK):
            b = min(nc, a + CHUNK)
            k = torch.randint(0, len(centres), (b - a,), generator=gen,
                              device=device)
            off = torch.randn((b - a, 3), generator=gen, device=device,
                              dtype=torch.float32)
            pos[a:b] = centres[k] + off * float(mix["clump_sigma"])
    mass = torch.ones((n,), dtype=torch.float32, device=device)
    return pos, mass


RHO_CRIT = 2.77519737e11  # h^2 Msun / Mpc^3


def plane_mass(mix, cfg, plane):
    """Each particle's mass (Msun/h) in the plane."""
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    rad = plane * binL + binL / 2.0
    vol = 4.0 * math.pi / 3.0 * ((rad + binL / 2.0) ** 3
                                 - max(rad - binL / 2.0, 0.0) ** 3)
    return cfg.OmegaM * RHO_CRIT * vol / int(mix["particles"])


def stage(mix, seed, device):
    """The mix's staged planes [(pos, mass), ...] from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    k = int(mix["staged_planes"])
    if k < 2:
        raise ValueError(f"a mix stages at least 2 planes, not {k}")
    return [plane(gen, mix, device) for _ in range(k)]
