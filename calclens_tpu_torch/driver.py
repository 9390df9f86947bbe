"""Multiple-plane ray-trace driver (reference raytrace.c), full sky.

Port of calclens_tpu/driver.py on one device: the outer loop over lens
planes runs on the host (each plane loads its particles), and everything
inside a plane (deposit, SHT Poisson solve, interpolation, propagation) is
torch work on the Raytracer's device.  The CUDA kernels run when that device
is a GPU; a CPU Raytracer runs their plain twins.  After each
MapRedshiftList plane, run() writes the lens maps (maps.py).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .config import RayTraceConfig
from . import maps as lm
from .cosmology import Cosmology, RHO_CRIT, CSOL
from .healpix import core as hp
from .healpix import torchhp
from .poisson import empty_plane_step_packed, plane_scalars, plane_step_packed
from .rays import soa
from .sht.plan import SHTPlan


def gauss_beam(fwhm_rad: float, lmax: int):
    """Gaussian beam window b_l = exp(-l(l+1) sigma^2 / 2)."""
    sigma = fwhm_rad / np.sqrt(8.0 * np.log(2.0))
    ls = np.arange(lmax + 1, dtype=np.float64)
    return np.exp(-0.5 * ls * (ls + 1.0) * sigma * sigma)


@dataclass
class PlaneParams:
    """Per-plane radii and unit factors (reference set_plane_params,
    raytrace.c:384-500)."""

    plane_num: int
    rad_minus1: float
    rad: float
    rad_plus1: float
    densfact: float
    backdens: float
    zlens: float


def plane_params(cfg: RayTraceConfig, cosmo: Cosmology,
                 plane_num: int) -> PlaneParams:
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    rad_minus1 = 0.0 if plane_num < 1 else (plane_num - 1.0) * binL + binL / 2.0
    rad = plane_num * binL + binL / 2.0
    rad_plus1 = (
        cfg.maxComvDistance
        if plane_num + 1 == cfg.NumLensPlanes
        else (plane_num + 1.0) * binL + binL / 2.0
    )
    if cfg.PointMassTest and not cfg.NFWHaloTest:
        radialvolume = rad * rad * binL  # 2nd-order estimate, exact for a point
    else:
        radialvolume = ((rad + binL / 2.0) ** 3 - (rad - binL / 2.0) ** 3) / 3.0
    zw = 1.0 / cosmo.acomvdist(rad) - 1.0
    densfact = (
        3.0 * 100.0 * 100.0 / CSOL / CSOL * cfg.OmegaM * rad * (1.0 + zw) * binL
        / (radialvolume * RHO_CRIT * cfg.OmegaM)
    )
    backdens = (
        0.0
        if cfg.NoBackDens
        else 3.0 * 100.0 * 100.0 / CSOL / CSOL * cfg.OmegaM * rad * (1.0 + zw) * binL
    )
    return PlaneParams(plane_num, rad_minus1, rad, float(rad_plus1), densfact,
                       backdens, zw)


def _full_sky(cfg) -> bool:
    return (cfg.minRa <= 0.0 and cfg.maxRa >= 360.0
            and cfg.minDec <= -90.0 and cfg.maxDec >= 90.0)


def _check_supported(cfg):
    """Raise for configuration values that later ROADMAP slices bring."""
    unsupported = [
        (cfg.DepositScheme == "CIC", "DepositScheme CIC", 6),
        (cfg.DepositScheme == "SPH", "DepositScheme SPH", 7),
        (not cfg.SHTOnly, "SHTOnly = 0 (multigrid refinement)", 11),
        (cfg.ThreeDPot, "ThreeDPot", 12),
        (cfg.UseHEALPixLensPlaneMaps, "UseHEALPixLensPlaneMaps", 6),
        (not _full_sky(cfg), "a cut-sky ra/dec box", 6),
        (bool(cfg.GalsFileList), "GalsFileList", 8),
        (bool(cfg.RayOutputName), "RayOutputName", 10),
        (cfg.Profile, "Profile (per-phase timing rows)", 10),
        (bool(cfg.CMBLensing), "CMBLensing", 9),
        (cfg.DebugIO, "DebugIO (field-map dumps)", 10),
    ]
    for bad, what, slice_no in unsupported:
        if bad:
            raise NotImplementedError(
                f"calclens_tpu_torch does not run {what} yet: it arrives with "
                f"ROADMAP Queue 1, slice {slice_no}")


class Raytracer:
    """End-to-end multiple-plane ray tracer on one device.

    Rays live on the full HEALPix grid at rayOrder, in RING order, as a
    packed [21, N] tensor on `device` (rays/soa.py).
    """

    def __init__(self, cfg: RayTraceConfig, device="cuda", dtype=None):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Raytracer on CUDA, but torch sees no GPU")
        self.dtype = dtype or (torch.float64 if cfg.Precision == "f64"
                               else torch.float32)
        self.cosmo = Cosmology(cfg.OmegaM)
        lmax = cfg.LMax if cfg.LMax > 0 else 3 * (1 << cfg.poissonOrder) - 1
        window = None
        if cfg.SmoothingBeamFWHM > 0.0:
            window = gauss_beam(cfg.SmoothingBeamFWHM, lmax)
        if cfg.HEALPixWindowFunctionPath:
            from .io.weights import read_pixel_window

            pw = read_pixel_window(cfg.HEALPixWindowFunctionPath,
                                   cfg.poissonOrder)[: lmax + 1]
            window = pw if window is None else window * np.pad(
                pw, (0, max(0, lmax + 1 - len(pw))), constant_values=1.0)
        ring_weights = None
        if cfg.HEALPixRingWeightPath:
            from .io.weights import read_ring_weights

            ring_weights = read_ring_weights(cfg.HEALPixRingWeightPath,
                                             cfg.poissonOrder)
        self.plan = SHTPlan(cfg.poissonOrder, self.device,
                            lmax=cfg.LMax if cfg.LMax > 0 else None,
                            dtype=self.dtype, window=window,
                            ring_weights=ring_weights)
        self.tab = torchhp.InterpTables(cfg.poissonOrder)
        self.rays_packed = None  # [21, N] tensor on self.device
        self._ray_nest = None    # host int64 nest index per ray (lazy)
        self.current_plane = 0
        self.map_num = 0
        self.timings = []
        # particle arrays are padded to bucket multiples (zero-mass entries)
        self.part_bucket = 4096

    # ------------------------------------------------------------------
    def init_rays(self):
        """Full-sky rays at rayOrder in RING order, at radius binL / 2."""
        cfg = self.cfg
        binL = cfg.maxComvDistance / cfg.NumLensPlanes
        npix = int(hp.order2npix(cfg.rayOrder))
        self._ray_nest = None
        self.rays_packed = soa.init_packed_fullsky(
            cfg.rayOrder, binL / 2.0, npix, self.device, self.dtype)
        self.current_plane = 0

    def load_state(self, packed, current_plane: int, map_num: int = 0):
        """Start from a given packed [21, N] ray state (for example
        np.asarray(rt_jax.rays_packed)) and plane counters."""
        packed = np.asarray(packed)
        npix = int(hp.order2npix(self.cfg.rayOrder))
        if packed.shape != (soa.NROWS, npix):
            raise ValueError(f"packed state has shape {packed.shape}, "
                             f"expected {(soa.NROWS, npix)}")
        self.rays_packed = torch.tensor(packed, dtype=self.dtype,
                                        device=self.device)
        self._ray_nest = None
        self.current_plane = int(current_plane)
        self.map_num = int(map_num)

    def _pad_particles(self, pos, mass):
        """Pad to the bucket size with zero-mass particles at a valid unit
        vector (they deposit nothing) and move them to the device."""
        if isinstance(pos, torch.Tensor) and len(pos) % self.part_bucket == 0:
            return (pos.to(self.device, self.dtype),
                    mass.to(self.device, self.dtype))
        n = len(pos)
        b = self.part_bucket
        npad = max(b, ((n + b - 1) // b) * b)
        pos_p = np.zeros((npad, 3))
        pos_p[:, 0] = 1.0
        mass_p = np.zeros((npad,))
        if n:
            pos_p[:n] = np.asarray(pos)
            mass_p[:n] = np.asarray(mass)
        return (torch.tensor(pos_p, dtype=self.dtype, device=self.device),
                torch.tensor(mass_p, dtype=self.dtype, device=self.device))

    @property
    def rays(self):
        """Host numpy Rays view of the packed ray buffer."""
        if self.rays_packed is None:
            return None
        return soa.unpack(self.rays_packed.cpu().numpy())

    @property
    def ray_nest(self):
        """Host nest index per ray (ray i sits at RING pixel i)."""
        if self._ray_nest is None:
            npix = int(hp.order2npix(self.cfg.rayOrder))
            self._ray_nest = hp.ring2nest(np.arange(npix, dtype=np.int64),
                                          self.cfg.rayOrder)
        return self._ray_nest

    # ------------------------------------------------------------------
    def load_particles(self, plane_num: int):
        """Dispatch by LensPlaneType (reference partio.c:42-61), with
        optional random subsampling + mass rescale (KEEP_RAND_FRAC,
        read_lensplanes_hdf5.c:90-122)."""
        cfg = self.cfg
        if cfg.LensPlaneType.lower() == "pixlc":
            from .io import pixlc

            pos, mass = pixlc.read_plane(cfg.LensPlanePath, cfg.LensPlaneName,
                                         plane_num)[:2]
        else:
            from .io import lensplanes

            fn = lensplanes.plane_filename(cfg.LensPlanePath,
                                           cfg.LensPlaneName, plane_num)
            pos, mass = lensplanes.read_plane(fn)
        if 0.0 < cfg.KeepRandFrac < 1.0 and len(pos):
            rng = np.random.default_rng(plane_num)  # deterministic per plane
            keep = rng.random(len(pos)) < cfg.KeepRandFrac
            pos = pos[keep]
            mass = mass[keep] / cfg.KeepRandFrac
        return pos, mass

    def step(self, plane_num: int, pos=None, mass=None,
             with_maps: bool = False):
        """One plane: Poisson solve at the plane radius, then propagate to
        the next plane.  Returns the FieldMaps when with_maps."""
        t0 = time.perf_counter()
        pp = plane_params(self.cfg, self.cosmo, plane_num)
        if pos is None:
            pos, mass = self.load_particles(plane_num)
        scal = plane_scalars(pp, self.dtype, self.device)
        maps = None
        if len(pos):
            pos_d, mass_d = self._pad_particles(pos, mass)
            packed, maps = plane_step_packed(
                self.plan, self.tab, self.rays_packed, pos_d, mass_d,
                self.cfg.BornApprx, with_maps, scal)
        else:
            # empty planes keep the beta chord (see calclens_tpu/driver.py)
            packed = empty_plane_step_packed(self.cfg.BornApprx,
                                             self.rays_packed, scal)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rays_packed = packed
        self.current_plane = plane_num + 1
        self.timings.append((plane_num, time.perf_counter() - t0))
        return maps

    # ------------------------------------------------------------------
    def restart_path(self):
        return f"{self.cfg.OutputPath or '.'}/restart.npz"

    def save_restart(self, path=None):
        from . import restart as rst

        rst.write_restart(path or self.restart_path(), self.cfg, self.rays,
                          self.ray_nest, self.current_plane, self.map_num)

    def load_restart(self, path=None):
        from . import restart as rst

        rays, nest, self.current_plane, self.map_num = rst.read_restart(
            path or self.restart_path(), self.cfg,
            np.float64 if self.dtype == torch.float64 else np.float32)
        self.rays_packed = soa.pack(
            type(rays)(*(torch.as_tensor(x, device=self.device)
                         for x in rays)))
        self._ray_nest = nest

    def _map_planes(self):
        """plane number -> map index for MapRedshiftList planes."""
        cfg = self.cfg
        if not cfg.MapRedshiftList:
            return {}
        zs = lm.read_map_redshifts(cfg.MapRedshiftList)
        nums = lm.map_plane_nums(zs, cfg.OmegaM, cfg.maxComvDistance,
                                 cfg.NumLensPlanes)
        return {int(p): i for i, p in enumerate(nums)}

    def _map_order(self):
        return (lm.DRIVER_MAP_ORDER if self.cfg.LensMapOrder < 0
                else self.cfg.LensMapOrder)

    def _write_map_outputs(self):
        """Accumulate the lens maps on the rays' device (only the [7,
        npix_map] sums reach the host) and write Convergence_ and Rays_."""
        order = self._map_order()
        stacked = lm.accum_lens_map_packed(self.rays_packed, self._ray_nest,
                                           self.cfg.rayOrder, order)
        accum = lm.LensMapAccum.from_stacked(stacked)
        return lm.write_map_outputs(accum, order, self.cfg.OutputPath or ".",
                                    self.map_num)

    def run(self, progress=True, start_time=None):
        """Plane loop with lens maps and wall-time restarts (reference
        raytrace.c:131-371): after each MapRedshiftList plane the lens maps
        (when OutputPath is set); npz restarts every WallTimeBetweenRestart
        seconds and before the WallTimeLimit; at the end, the restart and
        the timing.0 rows."""
        cfg = self.cfg
        if self.rays_packed is None:
            self.init_rays()
        map_planes = self._map_planes()
        if map_planes and cfg.OutputPath:
            lm.check_map_order(cfg.rayOrder, self._map_order())
        t_start = start_time if start_time is not None else time.perf_counter()
        t_last_restart = t_start
        for p in range(self.current_plane, cfg.NumLensPlanes):
            self.step(p)
            if progress:
                pp = plane_params(cfg, self.cosmo, p)
                print(f"plane {p:4d}/{cfg.NumLensPlanes} "
                      f"[dist={pp.rad:.2f} Mpc/h, z={pp.zlens:.2f}] "
                      f"{self.timings[-1][1]:.3f}s", file=sys.stderr)
            if p in map_planes and cfg.OutputPath:
                self._write_map_outputs()
                self.map_num += 1
            now = time.perf_counter()
            step_t = self.timings[-1][1]
            if cfg.OutputPath and (
                    now - t_last_restart > cfg.WallTimeBetweenRestart):
                self.save_restart()
                t_last_restart = now
            if now - t_start > cfg.WallTimeLimit - 5.0 * step_t:
                # graceful preemption (raytrace.c:143-149)
                if cfg.OutputPath:
                    self.save_restart()
                return
        if cfg.OutputPath:
            self.save_restart()
            self.write_timing()

    def write_timing(self):
        """Per-plane step times (the reference's timing.0 rows,
        raytrace.c:54-64, 338-343)."""
        path = os.path.join(self.cfg.OutputPath, "timing.0")
        with open(path, "w") as fp:
            fp.write("# plane StepTime[s]\n")
            for p, t in self.timings:
                fp.write(f"{p} {t:.6f}\n")
