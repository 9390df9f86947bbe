"""The ray side on a mesh: each rank interpolates its rays from its block of
the six field maps and a halo of H pixels on each side (port of
calclens_tpu/parallel/halo.py).

The maps stay as equal contiguous RING-pixel blocks (Mesh.blocks), so
no rank holds a whole [npix] map.  Rays are stored in RING order of their
pixels, so ray block k and map block k cover about the same band of
latitude (HEALPix pixels are equal-area); a ray's four bilinear taps lie in
its rank's map block and a halo bounded by the ring quantization and the
rays' accumulated deflection.  required_halo gives that bound.

The window's pixel-id row (row 6 of the [7, W] maps the interpolation
reads) carries the GLOBAL id of each of its columns, and the taps are
shifted by the window's first pixel (soa.interp_and_prop_chunk's pix_base),
so every tap's weight and transport are rebuilt from the pixel it really
read.  The pole folds tap the first and last four pixels of the map; only
rays of the first and last ray ring take them, and those rays live on ranks
0 and n - 1, where those pixels are in the block.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..healpix import core as hp
from ..rays import soa


def required_halo(ray_order: int, map_order: int, n_shards: int,
                  drift_rad: float = 0.02) -> int:
    """Halo size in map pixels for the sharded interpolation
    (calclens_tpu/parallel/halo.py::required_halo, host numpy).

    Exact per-ring quantization bound: for a ray at global pixel fraction f
    in ray ring i at azimuth fraction u, the tap index on map ring r is
    startpix_map[r] + u * ringpix_map[r] (+-2 for pixel-centre offsets);
    the window assumes the tap sits at f * npix_map.  The deviation is
    linear in u, so its max over the ring is at the endpoints.  drift_rad
    adds margin for accumulated ray deflection.  Warns when the halo
    exceeds one block (rays deflected beyond it would read clamped
    pixels) and returns at most one block."""
    rt_ray = hp.build_ring_table(ray_order)
    rt_map = hp.build_ring_table(map_order)
    npix_ray = float(rt_ray.npix)
    npix_map = float(rt_map.npix)
    nrings_map = 4 * rt_map.nside - 1

    theta = rt_ray.theta
    z = np.cos(theta)
    az = np.abs(z)
    nside_m = rt_map.nside
    ir_cap = (nside_m * np.sqrt(np.maximum(3.0 * (1.0 - az), 0.0))).astype(
        np.int64)
    ir_eq = (nside_m * (2.0 - 1.5 * z)).astype(np.int64)
    ring_above = np.where(az <= 2.0 / 3.0, ir_eq,
                          np.where(z > 0, ir_cap, 4 * nside_m - ir_cap - 1))
    dev = 0.0
    for ir in (ring_above, ring_above + 1):
        row = np.clip(ir, 1, nrings_map) - 1
        sp_m = rt_map.startpix[row].astype(np.float64)
        np_m = rt_map.ringpix[row].astype(np.float64)
        sp_r = rt_ray.startpix.astype(np.float64)
        np_r = rt_ray.ringpix.astype(np.float64)
        for u in (0.0, 1.0):
            tap = sp_m + u * np_m
            f = (sp_r + u * np_r) / npix_ray
            dev = max(dev, float(np.max(np.abs(tap - f * npix_map))))

    drift_rings = int(np.ceil(drift_rad / (np.pi / (4 * rt_map.nside)))) + 2
    H = int(dev) + 4 + drift_rings * 4 * rt_map.nside
    blk = rt_map.npix // n_shards
    if H > blk:
        warnings.warn(
            f"required_halo truncated: need {H} map pixels but the shard "
            f"block is only {blk}; rays deflected beyond one block will "
            f"read clamped (wrong) pixels. Use fewer shards or check the "
            f"deflections.", stacklevel=2)
    return min(H, blk)


def interp_and_prop_sharded(tab, maps6, packed, wp, wpm1, wpm2, born: bool,
                            mesh, halo: int, chunk: int):
    """The ray side on the mesh (calclens_tpu/parallel/halo.py::
    interp_and_prop_sharded): maps6 [6, b - a] this rank's pixel block
    (mesh.blocks(npix)), packed [21, c] its ray columns.  The window
    [a - H, b + H) of the six maps comes by one halo exchange
    (mesh.window); the rays are interpolated from it and propagated into
    a new buffer (soa.interp_and_prop: the kernel on the card, the plain
    twin in column chunks of `chunk` on the CPU)."""
    npix = tab.npix
    bounds = mesh.blocks(npix)
    win, lo = mesh.window(maps6, bounds, int(halo))
    maps7 = soa.with_pixel_ids(win, base=lo)
    del win
    return soa.interp_and_prop(tab, maps7, packed, wp, wpm1, wpm2, born,
                               pix_base=lo, chunk=chunk)
