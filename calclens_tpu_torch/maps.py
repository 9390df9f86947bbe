"""Lens maps: per-ray accumulation onto coarse HEALPix maps + FITS output
(reference maputils.c).

Port of calclens_tpu/maps.py on one device.  At each configured map
redshift the driver accumulates per-pixel sums of (count, A00, A01, A10,
A11, ra, dec) over all rays (updateLensMap, maputils.c:129-165; NGP on the
NESTED map at map_order) on the rays' device, and writes:
  Convergence_<nside>_<mapnum>.fits : SIGNAL = 1 - (A00+A11)/2 per-pixel mean
  Rays_<nside>_<mapnum>.fits        : 8-column table of per-pixel means
Only the [7, npix_map] sums reach the host, never the [21, N] ray buffer.
The closed-form flat-LCDM distance (Gauss 2F1 form, maputils.c:19-38) maps
the redshift list to lens-plane numbers.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import hyp2f1

from .healpix import core as hp
from .healpix import torchhp
from .io import fits

DRIVER_MAP_ORDER = 11  # reference raytrace.c map_n_side = 2048
CMB_MAP_ORDER = 12     # propagate_to_cmb_from_restart.c order-12 maps
HUBBLE_DISTANCE = 2997.92458  # Mpc/h


def comoving_distance_2f1(z, omega_m):
    """Closed-form flat-LCDM comoving distance (maputils.c:19-38)."""
    z = np.asarray(z, dtype=np.float64)
    ol = 1.0 - omega_m
    inv_omlf = 1.0 / (ol + (1.0 + z) ** 3 * omega_m)
    near = ol * inv_omlf > 0.99
    full = HUBBLE_DISTANCE * (
        2.0 * hyp2f1(0.5, 1.0, 7.0 / 6.0, ol)
        - 2.0 * hyp2f1(0.5, 1.0, 7.0 / 6.0, ol * inv_omlf)
        * np.sqrt(inv_omlf) * (1.0 + z)
    )
    return np.where(near, HUBBLE_DISTANCE * z, full)


def map_plane_nums(redshifts, omega_m, max_comv_distance, num_lens_planes):
    """Redshift list -> lens-plane numbers (getMapLensPlaneNums)."""
    binL = max_comv_distance / num_lens_planes
    r = comoving_distance_2f1(np.asarray(redshifts, np.float64), omega_m)
    return np.round(r / binL).astype(np.int64)


def read_map_redshifts(path):
    """One redshift per line (readMapRedshifts)."""
    with open(path) as fp:
        return np.asarray([float(line) for line in fp if line.strip()])


def check_map_order(ray_order: int, map_order: int):
    """A map pixel is the NEST parent of 4^(ray_order - map_order) rays, so
    the map cannot be finer than the ray grid."""
    if map_order > ray_order:
        raise ValueError(
            f"LensMapOrder {map_order} is above rayOrder {ray_order}: a lens "
            f"map pixel sums the rays of its NEST children, so the map "
            f"cannot be finer than the ray grid (set LensMapOrder <= "
            f"rayOrder)")


class LensMapAccum(NamedTuple):
    """Per-pixel sums at map_order (NESTED), host numpy arrays."""

    count: np.ndarray  # [npix] int32
    A00: np.ndarray
    A01: np.ndarray
    A10: np.ndarray
    A11: np.ndarray
    ra: np.ndarray
    dec: np.ndarray

    @classmethod
    def from_stacked(cls, stacked):
        """Accumulated [7, npix] rows (count, A00, A01, A10, A11, ra, dec),
        a tensor on any device or an array -> host LensMapAccum (the only
        host transfer of the lens-map path: coarse-map sized)."""
        if isinstance(stacked, torch.Tensor):
            stacked = stacked.cpu().numpy()
        h = np.asarray(stacked).astype(np.float64)
        return cls(np.rint(h[0]).astype(np.int32), h[1], h[2], h[3], h[4],
                   h[5], h[6])


def lens_vals_packed(packed):
    """Packed rays [21, N] -> the seven accumulation rows [7, N] (count,
    A00, A01, A10, A11, ra, dec): updateLensMap's per-ray terms
    (maputils.c:129-165), componentwise.  theta is atan2(rho, z), not the
    JAX package's arccos(z / r): in float32 that is off by eps / sin theta
    near the poles (0.01 degree on rayOrder 10's first ring)."""
    nx, ny, nz = packed[0], packed[1], packed[2]
    theta = torch.atan2(torch.sqrt(nx * nx + ny * ny), nz)
    phi = torch.atan2(ny, nx)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    ra = phi * (180.0 / math.pi)
    dec = 90.0 - theta * (180.0 / math.pi)
    return torch.stack([torch.ones_like(nx), packed[6], packed[7], packed[8],
                        packed[9], ra, dec])


def accum_lens_map_fullsky(packed, ray_order: int, map_order: int,
                           npix_map: int):
    """Full-sky accumulation without a scatter: ray i sits at RING pixel i
    (driver init), and in NEST order every map_order parent owns exactly
    4^k consecutive children, so one gather into NEST order followed by a
    reshape-sum gives the sums.  In the ray buffer's dtype, as in JAX."""
    check_map_order(ray_order, map_order)
    N = packed.shape[1]
    k = ray_order - map_order
    perm = torchhp.nest2ring_dev(
        torch.arange(N, dtype=torch.int32, device=packed.device), ray_order)
    vals = lens_vals_packed(packed).index_select(1, perm.long())
    return vals.reshape(7, npix_map, 1 << (2 * k)).sum(dim=-1)


def update_lens_map_stacked(accum7, packed, lpix):
    """Add packed rays into the stacked [7, npix_map] accumulator at coarse
    NEST pixels lpix [N] (general path: ray sets not on the full grid).
    Returns a new tensor; accum7 is not changed."""
    return accum7.index_add(1, lpix.long(),
                            lens_vals_packed(packed).to(accum7.dtype))


def accum_lens_map_packed(packed, ray_nest, ray_order: int, map_order: int):
    """Lens-map accumulation on the device of the packed ray buffer.

    ray_nest None means the full-sky RING-ordered grid (driver init_rays);
    otherwise it is the host nest-index array of the rays (for example
    from a restart).  Returns stacked [7, npix_map]; wrap with
    LensMapAccum.from_stacked for the FITS writers."""
    check_map_order(ray_order, map_order)
    npix_map = int(hp.order2npix(map_order))
    if ray_nest is None:
        return accum_lens_map_fullsky(packed, ray_order, map_order, npix_map)
    lpix = torch.as_tensor(np.asarray(ray_nest, np.int64)
                           >> (2 * (ray_order - map_order)),
                           device=packed.device)
    accum7 = torch.zeros((7, npix_map), dtype=packed.dtype,
                         device=packed.device)
    return update_lens_map_stacked(accum7, packed, lpix)


def _healpix_header(nside):
    return {
        "PIXTYPE": ("HEALPIX", "HEALPIX Pixelisation"),
        "ORDERING": ("NESTED", "Pixel ordering scheme, either RING or NESTED"),
        "NSIDE": (nside, "Resolution parameter for HEALPIX"),
        "FIRSTPIX": 0,
        "LASTPIX": 12 * nside * nside,
        "COORDSYS": ("C", "Pixelisation coordinate system"),
    }


def write_lens_map_fits(accum: LensMapAccum, nside, filename):
    """8-column per-pixel-mean table (writeFITSHEALPixLensMap)."""
    cnt = np.asarray(accum.count, np.int64)
    good = cnt > 0
    safe = np.where(good, cnt, 1).astype(np.float64)

    def avg(x):
        return np.where(good, np.asarray(x, np.float64) / safe, 0.0)

    npix = len(cnt)
    rec = np.zeros(npix, dtype=np.dtype([
        ("NEST_IDX", "<i4"), ("N_RAYS", "<i4"),
        ("A00", "<f8"), ("A01", "<f8"), ("A10", "<f8"), ("A11", "<f8"),
        ("ra", "<f8"), ("dec", "<f8"),
    ]))
    rec["NEST_IDX"] = np.arange(npix)
    rec["N_RAYS"] = cnt
    for k in ("A00", "A01", "A10", "A11", "ra", "dec"):
        rec[k] = avg(getattr(accum, k))
    fits.write_fits(filename, [
        fits.image_hdu(np.zeros(0, np.int16)),
        fits.bintable_hdu(rec, name="CMB_lensing_map",
                          header=_healpix_header(nside)),
    ])


def write_single_map_fits(signal, nside, filename, ordering="NESTED"):
    """HEALPix-convention single-column SIGNAL map
    (writeSingleFITSHEALPixLensMap)."""
    rec = np.zeros(12 * nside * nside, dtype=np.dtype([("SIGNAL", "<f4")]))
    rec["SIGNAL"] = np.asarray(signal, np.float32)
    hdr = _healpix_header(nside)
    hdr["ORDERING"] = (ordering, "Pixel ordering scheme, either RING or NESTED")
    fits.write_fits(filename, [
        fits.image_hdu(np.zeros(0, np.int16)),
        fits.bintable_hdu(rec, name="BINTABLE", header=hdr),
    ])


def write_debug_field_maps(field_maps, order, output_path, plane_num):
    """DEBUG_IO analog (shtpoissonsolve.c:584-604): dump the potential and
    its five covariant derivative maps of a plane as RING-ordered FITS
    files debug_<name>_<plane>.fits.  field_maps: FieldMaps or the stacked
    [6, npix] tensor."""
    os.makedirs(output_path, exist_ok=True)
    names = ("pot", "dtheta", "dphi", "dthetatheta", "dthetaphi", "dphiphi")
    paths = []
    for name, m in zip(names, field_maps):
        p = os.path.join(output_path, f"debug_{name}_{plane_num:04d}.fits")
        write_single_map_fits(torch.as_tensor(m).cpu().numpy(), 1 << order,
                              p, ordering="RING")
        paths.append(p)
    return paths


def convergence_from_accum(accum: LensMapAccum):
    """kappa = 1 - (A00 + A11)/2 per-pixel mean (raytrace.c:299-301)."""
    cnt = np.asarray(accum.count, np.float64)
    good = cnt > 0
    safe = np.where(good, cnt, 1.0)
    a00 = np.asarray(accum.A00, np.float64)
    a11 = np.asarray(accum.A11, np.float64)
    return np.where(good, 1.0 - 0.5 * (a00 + a11) / safe, 0.0).astype(np.float32)


def write_map_outputs(accum: LensMapAccum, map_order, output_path, map_num):
    """Write both Convergence_ and Rays_ files (raytrace.c:271-333)."""
    os.makedirs(output_path, exist_ok=True)
    nside = 1 << map_order
    conv = convergence_from_accum(accum)
    cpath = os.path.join(output_path, f"Convergence_{nside}_{map_num}.fits")
    write_single_map_fits(conv, nside, cpath)
    rpath = os.path.join(output_path, f"Rays_{nside}_{map_num}.fits")
    write_lens_map_fits(accum, nside, rpath)
    return cpath, rpath
