"""Particle -> HEALPix surface-density deposit (reference shtpoissonsolve.c
step 1, :110-291), NGP scheme.

Port of calclens_tpu/ops/deposit.py (deposit_ngp, scale_density): a
scatter-add straight into the RING-ordered map, the SHT's native layout.
Masses are scaled by 1/MASS_SCALE at deposit and rescaled in the Poisson
solve (shtpoissonsolve.c:36,153) to keep float32 sums in range.
"""

from __future__ import annotations

import torch

from ..healpix import torchhp

MASS_SCALE = 1e10  # reference shtpoissonsolve.c:36


def deposit_ngp(order: int, pos, mass, npix: int):
    """Nearest-grid-point deposit.  pos [N, 3] (any radius), mass [N]."""
    theta, phi = torchhp.vec2ang(pos)
    pix = torchhp.ang2pix_ring(theta, phi, order)
    m = torch.zeros((npix,), dtype=mass.dtype, device=mass.device)
    return m.index_add_(0, pix, mass / MASS_SCALE)


def scale_density(dens, densfact, backdens, pixarea):
    """densfact/pixarea scaling and background subtraction
    (shtpoissonsolve.c:454-502, full sky)."""
    return dens * (densfact / pixarea * MASS_SCALE) - backdens
