"""Multiple-plane ray-trace driver (reference raytrace.c), full sky or an
ra/dec box.

Port of calclens_tpu/driver.py on one device: the outer loop over lens
planes runs on the host (each plane loads its particles or its precomputed
mass map), and everything inside a plane (deposit, SHT Poisson solve,
interpolation, propagation) is torch work on the Raytracer's device.  The
CUDA kernels run when that device is a GPU; a CPU Raytracer runs their
plain twins.  After each MapRedshiftList plane, run() writes the lens maps
(maps.py); with GalsFileList it images the source galaxies of each plane's
radial bin (gals/) before that plane's step; with RayOutputName it writes
the ray files (io/rayio.py) at the end; with DebugIO each plane's six field
maps.  SHTOnly = 0 takes the multigrid-refined step (poisson.plane_step_mg,
mgdriver.py); ThreeDPot the 3D FFT potential of the nearest N-body
snapshot (fftpot.py).  propagate_to_cmb carries the rays on to the
last-scattering surface (the CMB mode).

On a mesh (Raytracer(..., mesh=Mesh), parallel/sharding.py) each rank
holds a contiguous block of the ray columns and of each plane's particle
rows.  The SHT-only step runs sharded (poisson.py: the map deposit
reduce-scattered onto pixel blocks, the transforms on the rank's m rows).
The multigrid step (SHTOnly 0) adds the sharded patch solve, as the JAX
driver's plane_step_mg with spec=plan.spec (calclens_tpu/mgdriver.py
mg_refine): the patch deposit reduce-scattered onto the rank's block of
patches, its BC fill and FAS cycles there, the solved patches gathered
whole for the rank's rays.  THREEDPOT builds each grid from the ranks'
shares of the snapshot by a slab-decomposed solve (fftpot.ThreeDPotDriver,
parallel/slabfft.py) and holds it whole on every rank, as the JAX driver
does, for the rank's rays.  The lens maps, the ray files, the npz restarts
and the galaxy images are reduced or gathered to rank 0, which writes the
same files a one-device run writes; the sharded checkpoint that run()
writes is written by every rank, each its own columns.
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
from .ops.deposit import MASS_SCALE, sph_sigma_grid
from .poisson import (empty_plane_step_packed, plane_scalars,
                      plane_step_density_packed, plane_step_mg,
                      plane_step_packed)
from .rays import soa
from .sht.plan import SHTPlan
from .utils.profile import Profiler, count, plane_span, span, sync

MIN_SMOOTH_TO_RAY_RATIO = 0.5  # reference raytrace.h:123
# degrees by which the vacuum mask widens the ra/dec box (the JAX package's)
VACUUM_BUFFER_DEG = 5.0
# pixels per chunk of the vacuum mask's device computation
VACMASK_CHUNK = 1 << 24


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


def sph_params(cfg: RayTraceConfig):
    """The SPH deposit's static tuple (8 sigmas..., csl, min_sl, max_sl):
    the clamp range from the ray-grid floor to the first plane's angular
    scale (reference raytrace.c:425-450), the sigma grid log-spaced in it."""
    ray_pix = np.sqrt(4.0 * np.pi / hp.order2npix(cfg.rayOrder))
    min_sl = MIN_SMOOTH_TO_RAY_RATIO * ray_pix
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    csl = (cfg.ComvSmoothingScale if cfg.ComvSmoothingScale > 0
           else binL / 10)
    max_sl = min(np.pi / 2, csl / (binL / 2.0))
    max_sl = max(max_sl, 2 * min_sl)
    sigmas = sph_sigma_grid(min_sl, max_sl, 8)
    return tuple(float(s) for s in sigmas) + (float(csl), float(min_sl),
                                              float(max_sl))


class Raytracer:
    """End-to-end multiple-plane ray tracer on one device, or on a mesh of
    ranks (mesh: a parallel.sharding.Mesh; device is then this rank's).

    Rays live on the HEALPix grid at rayOrder (full sky, or its pixels in
    the configured ra/dec box), in RING order of their pixels, as a packed
    [21, N] tensor on `device` (rays/soa.py); on a mesh each rank holds the
    columns ray_bounds[rank] .. ray_bounds[rank + 1] of it.
    """

    def __init__(self, cfg: RayTraceConfig, device="cuda", dtype=None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
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
                            ring_weights=ring_weights, mesh=mesh)
        self.tab = torchhp.InterpTables(cfg.poissonOrder)
        self.sph = sph_params(cfg) if cfg.DepositScheme == "SPH" else None
        # [npix] bool on the device, True outside the buffered box; None for
        # the full sky
        self.vacmask = self.vacuum_mask()
        self.rays_packed = None  # [21, N] tensor on self.device
        self.ray_bounds = None   # [n + 1] column bounds of the ranks
        self._halo_px = None     # the ray side's halo on a mesh (_halo)
        self._ray_nest = None    # host int64 nest index per ray (lazy)
        self.current_plane = 0
        self.map_num = 0
        self.timings = []
        # non-SHTONLY: the patch tables (built at the first plane) and the
        # V-cycles each plane's patch solve took
        self.mgsetup = None
        self.mg_cycles = {}
        # ThreeDPot: the snapshot list and the cached potential grid (built
        # at the first plane)
        self.threedpot = None
        self._nest_dev = (None, None)  # (_ray_nest, its device copy)
        # particle arrays are padded to bucket multiples (zero-mass entries)
        self.part_bucket = 4096
        # per-phase profiler (reference profile.c tags), filled in
        # cfg.Profile mode, where the plane step runs phase by phase with a
        # device sync at each boundary
        self.profiler = Profiler()
        self.phase_rows = []

    # ------------------------------------------------------------------
    def active_ray_pixels(self):
        """NEST pixel indices at rayOrder inside the configured sky box
        (reference init_bundlecells + init_rays), sorted by RING index: the
        field maps are RING-ordered, so the interpolation gathers walk
        memory nearly in order.  Coarse first: bundle cells in a buffered
        box, then only their children filtered exactly."""
        cfg = self.cfg
        cnpix = int(hp.order2npix(cfg.bundleOrder))
        cnest = np.arange(cnpix, dtype=np.int64)
        cth, cph = hp.pix2ang_nest(cnest, cfg.bundleOrder)
        cra, cdec = hp.ang2radec(cth, cph)
        buf = 2.0 * np.degrees(np.sqrt(4.0 * np.pi / cnpix))
        csel = ((cra >= cfg.minRa - buf) & (cra <= cfg.maxRa + buf)
                & (cdec >= cfg.minDec - buf) & (cdec <= cfg.maxDec + buf))
        k = 2 * (cfg.rayOrder - cfg.bundleOrder)
        children = ((cnest[csel][:, None] << k)
                    + np.arange(1 << k, dtype=np.int64)).reshape(-1)
        theta, phi = hp.pix2ang_nest(children, cfg.rayOrder)
        ra, dec = hp.ang2radec(theta, phi)
        keep = ((ra >= cfg.minRa) & (ra <= cfg.maxRa)
                & (dec >= cfg.minDec) & (dec <= cfg.maxDec))
        nest = children[keep]
        return nest[np.argsort(hp.nest2ring(nest, cfg.rayOrder))]

    def vacuum_mask(self):
        """True at poissonOrder pixels outside the ra/dec box widened by
        VACUUM_BUFFER_DEG: these are zeroed instead of background-subtracted
        (the reference's test_vaccell cut-sky handling,
        shtpoissonsolve.c:454-502).  None for the full sky.  Computed on the
        device in float32, in the JAX package's steps (RING pixel centre ->
        unit vector -> arccos, arctan2 -> degrees), in chunks of
        VACMASK_CHUNK pixels."""
        cfg = self.cfg
        if _full_sky(cfg):
            return None
        npix = int(hp.order2npix(cfg.poissonOrder))
        mask = torch.empty(npix, dtype=torch.bool, device=self.device)
        for a in range(0, npix, VACMASK_CHUNK):
            pix = torch.arange(a, min(npix, a + VACMASK_CHUNK),
                               device=self.device)
            x, y, z = torchhp.pix2vec_ring_soa(pix, cfg.poissonOrder,
                                               torch.float32)
            theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
            phi = torch.atan2(y, x)
            phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
            ra = torch.rad2deg(phi)
            dec = 90.0 - torch.rad2deg(theta)
            b = VACUUM_BUFFER_DEG
            inside = ((ra >= cfg.minRa - b) & (ra <= cfg.maxRa + b)
                      & (dec >= cfg.minDec - b) & (dec <= cfg.maxDec + b))
            mask[a:a + len(pix)] = ~inside
        return mask

    def init_rays(self):
        """Rays at radius binL / 2 on the rayOrder pixels: the full sky in
        RING order (built on the device), or the box's pixels
        (active_ray_pixels), whose packed buffer is built on the host from
        float64 pixel vectors and cast to the run's dtype, as the JAX
        package builds it."""
        cfg = self.cfg
        binL = cfg.maxComvDistance / cfg.NumLensPlanes
        self.current_plane = 0
        if _full_sky(cfg):
            npix = int(hp.order2npix(cfg.rayOrder))
            self._ray_nest = None
            c0, c1 = self._columns(npix)
            self.rays_packed = soa.init_packed_fullsky(
                cfg.rayOrder, binL / 2.0, c1 - c0, self.device, self.dtype,
                pix0=c0)
            return
        self._ray_nest = self.active_ray_pixels()
        vec = hp.pix2vec_nest(self._ray_nest, cfg.rayOrder)
        packed = np.zeros((soa.NROWS, len(vec)), dtype=self._np_dtype)
        packed[0:3] = (vec * (binL / 2.0)).T
        packed[3:6] = vec.T
        packed[6] = packed[9] = packed[10] = packed[13] = 1.0  # A = Aprev = I
        self.rays_packed = self._my_columns(packed)

    # ------------------------------------------------------------------
    # the ray columns on a mesh
    # ------------------------------------------------------------------
    def _columns(self, N):
        """(c0, c1): the ray columns this rank holds ((0, N) on one
        device); sets ray_bounds."""
        if self.mesh is None:
            self.ray_bounds = np.array([0, N], np.int64)
            return 0, N
        self.ray_bounds = self.mesh.blocks(N)
        return self.mesh.block(N)

    def _my_columns(self, packed):
        """Host [21, N] -> a copy of this rank's columns on the device."""
        c0, c1 = self._columns(packed.shape[1])
        return torch.tensor(np.ascontiguousarray(packed[:, c0:c1]),
                            device=self.device)

    def packed_global(self):
        """The whole [21, N] ray buffer on every rank (the packed buffer
        itself on one device): the ranks' columns gathered."""
        if self.mesh is None:
            return self.rays_packed
        return self.mesh.all_gather_cols(self.rays_packed, self.ray_bounds)

    def _rank0(self):
        return self.mesh is None or self.mesh.rank == 0

    def _agree(self, flag):
        """Rank 0's value of a host decision, on every rank (so every rank
        makes the same collective calls)."""
        if self.mesh is None:
            return flag
        return self.mesh.broadcast_object(flag, 0)

    def _halo(self):
        """The ray side's halo on a mesh (parallel/halo.required_halo),
        when the rays are the full sky's in RING order and both the rays
        and the map divide into the ranks' equal blocks; else None: the
        ray side then reads the maps gathered whole."""
        mesh = self.mesh
        if mesh is None or self._ray_nest is not None:
            return None
        N = int(self.ray_bounds[-1])
        if N % mesh.size or self.plan.npix % mesh.size:
            return None
        if self._halo_px is None:
            from .parallel.halo import required_halo

            self._halo_px = required_halo(self.cfg.rayOrder,
                                          self.cfg.poissonOrder, mesh.size)
        return self._halo_px

    def load_state(self, packed, current_plane: int, map_num: int = 0):
        """Start from a given packed [21, N] ray state (for example
        np.asarray(rt_jax.rays_packed)) and plane counters: N is every
        rayOrder pixel for the full sky, len(active_ray_pixels()) for a
        box, in init_rays' order."""
        packed = np.asarray(packed)
        nest = None if _full_sky(self.cfg) else self.active_ray_pixels()
        n = (int(hp.order2npix(self.cfg.rayOrder)) if nest is None
             else len(nest))
        if packed.shape != (soa.NROWS, n):
            raise ValueError(f"packed state has shape {packed.shape}, "
                             f"expected {(soa.NROWS, n)}")
        self.rays_packed = self._my_columns(
            np.asarray(packed, dtype=self._np_dtype))
        self._ray_nest = nest
        self.current_plane = int(current_plane)
        self.map_num = int(map_num)

    @property
    def _np_dtype(self):
        return np.float64 if self.dtype == torch.float64 else np.float32

    def stage_particles(self, pos, mass):
        """The whole plane's particles padded to the bucket size with
        zero-mass particles at a valid unit vector (they deposit nothing),
        on the device: what step takes as it is.  Tensors whose length is
        already a bucket multiple are only moved."""
        if not (isinstance(pos, torch.Tensor)
                and len(pos) % self.part_bucket == 0):
            pos, mass = self._pad_host(pos, mass)
        return (torch.as_tensor(pos).to(self.device, self.dtype),
                torch.as_tensor(mass).to(self.device, self.dtype))

    def _pad_host(self, pos, mass):
        n = len(pos)
        b = self.part_bucket
        npad = max(b, ((n + b - 1) // b) * b)
        pos_p = np.zeros((npad, 3))
        pos_p[:, 0] = 1.0
        mass_p = np.zeros((npad,))
        if n:
            pos_p[:n] = np.asarray(pos)
            mass_p[:n] = np.asarray(mass)
        return pos_p, mass_p

    def _pad_particles(self, pos, mass):
        """pos, mass: the whole plane's particles (host arrays or tensors,
        on a mesh as on one device) -> this rank's block of the rows that
        stage_particles gives, on the device (all of them on one
        device)."""
        if self.mesh is None:
            return self.stage_particles(pos, mass)
        if not (isinstance(pos, torch.Tensor)
                and len(pos) % self.part_bucket == 0):
            pos, mass = self._pad_host(pos, mass)
        a, b = self.mesh.block(len(pos))
        return (torch.as_tensor(pos[a:b]).to(self.device, self.dtype),
                torch.as_tensor(mass[a:b]).to(self.device, self.dtype))

    def _plane_count(self, pos):
        """The plane's particle count, the same on every rank: on a mesh
        the ranks' counts are compared, and differing ones raise on every
        rank at once (so no rank takes the empty plane's step while the
        others wait in the deposit's collectives)."""
        n = 0 if pos is None else len(pos)
        if self.mesh is None:
            return n
        counts = self.mesh.all_gather_object(n)
        if len(set(counts)) > 1:
            raise ValueError(f"the ranks were given different planes: "
                             f"particle counts {counts} (every rank takes "
                             f"the whole plane)")
        return n

    @property
    def rays(self):
        """Host numpy Rays view of the packed ray buffer (on a mesh, of the
        whole buffer: a collective)."""
        if self.rays_packed is None:
            return None
        return soa.unpack(self.packed_global().cpu().numpy())

    @property
    def ray_nest(self):
        """Host nest index per ray (full sky: ray i sits at RING pixel
        i)."""
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

    def load_mass_map(self, plane_num: int):
        """The plane's precomputed count map (io/healpix_maps.py) times
        partMass / MASS_SCALE on the device: mass per pixel in the deposit's
        units.  The product is taken in the file's float32, as the JAX
        package takes it."""
        from .io import healpix_maps

        cfg = self.cfg
        counts = healpix_maps.read_plane_map(
            cfg.HEALPixLensPlaneMapPath, cfg.HEALPixLensPlaneMapName,
            plane_num, self.plan.npix)
        if self.mesh is not None:
            a, b = self.mesh.block(self.plan.npix)
            counts = counts[a:b]
        return torch.tensor(counts * (cfg.partMass / MASS_SCALE),
                            dtype=self.dtype, device=self.device)

    def step(self, plane_num: int, pos=None, mass=None,
             with_maps: bool = False):
        """One plane: Poisson solve at the plane radius, then propagate to
        the next plane.  Returns the FieldMaps when with_maps (DebugIO
        with OutputPath sets it and writes them); the multigrid step
        (SHTOnly = 0) returns none.  With UseHEALPixLensPlaneMaps the
        plane's mass map is read, with ThreeDPot the nearest snapshot's 3D
        potential grid gives the plane (fftpot.py), and pos, mass are not
        used.  Under a torch.profiler the step is the PLANE span
        (utils/profile.py)."""
        with plane_span(self.device):
            return self._step(plane_num, pos, mass, with_maps)

    def _step(self, plane_num, pos, mass, with_maps):
        cfg = self.cfg
        if cfg.DebugIO and cfg.OutputPath:
            with_maps = True
        t0 = time.perf_counter()
        pp = plane_params(cfg, self.cosmo, plane_num)
        kw = {"phase": self._timed_phase(plane_num)} if cfg.Profile else {}
        scal = plane_scalars(pp, self.dtype, self.device)
        if cfg.ThreeDPot:
            # 3D FFT potential path (THREEDPOT, fftpoissondriver.c:45): no
            # particle load, the snapshot's grid gives the plane's rows
            packed = self._threedpot().step(
                self.rays_packed, scal, cfg.BornApprx, pp.rad,
                cfg.maxComvDistance / cfg.NumLensPlanes, **kw)
            maps = None
        elif cfg.UseHEALPixLensPlaneMaps:
            density = self.load_mass_map(plane_num)
            if cfg.Profile:
                self._note_phase(plane_num, "PARTIO",
                                 time.perf_counter() - t0)
            packed, maps = plane_step_density_packed(
                self.plan, self.tab, self.rays_packed, density,
                cfg.BornApprx, with_maps, scal, self.vacmask, halo=self._halo(),
                **kw)
        else:
            if pos is None:
                pos, mass = self.load_particles(plane_num)
                if cfg.Profile:
                    self._note_phase(plane_num, "PARTIO",
                                     time.perf_counter() - t0)
            maps = None
            npart = self._plane_count(pos)
            if not cfg.SHTOnly and npart:
                # multigrid-refined short-range force (non-SHTONLY mode)
                pos_d, mass_d = self._pad_particles(pos, mass)
                packed, cycles = plane_step_mg(
                    self.plan, self.tab, self._mg_setup(), self.rays_packed,
                    pos_d, mass_d, cfg.DepositScheme, cfg.BornApprx, scal,
                    self.vacmask, float(cfg.MGConvFact), self.sph,
                    self._ray_nest_dev(), col0=self._col0(), **kw)
                self.mg_cycles[plane_num] = cycles
            elif npart:
                pos_d, mass_d = self._pad_particles(pos, mass)
                packed, maps = plane_step_packed(
                    self.plan, self.tab, self.rays_packed, pos_d, mass_d,
                    cfg.BornApprx, with_maps, scal, cfg.DepositScheme,
                    self.vacmask, self.sph, halo=self._halo(), **kw)
            else:
                # empty planes keep the beta chord (see
                # calclens_tpu/driver.py)
                packed = empty_plane_step_packed(cfg.BornApprx,
                                                 self.rays_packed, scal)
        with span("SYNC"):
            count("host_sync")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.rays_packed = packed
        self.current_plane = plane_num + 1
        self.timings.append((plane_num, time.perf_counter() - t0))
        if maps is not None and cfg.DebugIO and cfg.OutputPath:
            if self.mesh is not None:
                whole = self.mesh.all_gather_cols(torch.stack(list(maps)),
                                                  self.plan.pix_bounds)
                maps = type(maps)(*whole.unbind(0))
            if self._rank0():
                lm.write_debug_field_maps(maps, cfg.poissonOrder,
                                          cfg.OutputPath, plane_num)
        return maps

    def _threedpot(self):
        """The THREEDPOT snapshot driver (fftpot.ThreeDPotDriver), made at
        the first plane on the rays' device (and mesh)."""
        if self.threedpot is None:
            from .fftpot import ThreeDPotDriver

            self.threedpot = ThreeDPotDriver(self.cfg, self.cosmo,
                                             self.device, self.mesh)
        return self.threedpot

    def _ray_nest_dev(self):
        """_ray_nest of this rank's columns on the rays' device (None for
        full-sky rays in RING order), uploaded once per array: the
        multigrid step reads each ray chunk's cells from it without a host
        -> device copy."""
        if self._ray_nest is None:
            return None
        if self._nest_dev[0] is not self._ray_nest:
            nest = self._ray_nest
            if self.mesh is not None:
                nest = nest[self._col0():
                            int(self.ray_bounds[self.mesh.rank + 1])]
            self._nest_dev = (self._ray_nest, torch.as_tensor(
                np.asarray(nest, np.int64), device=self.device))
        return self._nest_dev[1]

    def _col0(self):
        """The global index of this rank's first ray column (0 on one
        device)."""
        return 0 if self.mesh is None else int(self.ray_bounds[self.mesh.rank])

    def _mg_setup(self):
        """The patch tables of the non-SHTONLY step, built at the first
        plane: patches of 4 cell widths, fine grid n = choose_patch_n(4
        cell, cell / 16, 64, 256) (the JAX driver's sizing; 128 at
        bundleOrder 6), the SPH sigmas when DepositScheme is SPH."""
        if self.mgsetup is None:
            from . import mgdriver
            from .mg import choose_patch_n

            cell = np.sqrt(4.0 * np.pi / hp.order2npix(self.cfg.bundleOrder))
            n = choose_patch_n(4.0 * cell, cell / 16.0, n_min=64, n_max=256)
            self.mgsetup = mgdriver.MGSetup(self.cfg.bundleOrder, n,
                                            self.cfg.rayOrder,
                                            dtype=self.dtype)
            if self.sph is not None:
                self.mgsetup.sph_sigmas = self.sph[:-3]
        return self.mgsetup

    # ------------------------------------------------------------------
    def _phase_row(self, plane_num):
        """The plane's dict of phase times in phase_rows (added if new)."""
        for p, r in self.phase_rows:
            if p == plane_num:
                return r
        row = {}
        self.phase_rows.append((plane_num, row))
        return row

    def _note_phase(self, plane_num, tag, dt):
        """Add a phase time to the plane's timing.0 row and the profiler."""
        row = self._phase_row(plane_num)
        row[tag] = row.get(tag, 0.0) + dt
        self.profiler.add(tag, dt)

    def _timed_phase(self, plane_num):
        """plane_step_packed's phase hook in Profile mode: each phase
        (DEPOSIT, SHTSOLVE = analysis + filter, SHT = the six-map synthesis,
        RAYPROP = interpolation + propagation) timed on the host clock up to
        a device sync of its output (the reference's per-plane phase rows,
        shtpoissonsolve.c:521-576 + profile.c).  The step makes the same
        calls as without Profile, so it gives the same numbers."""
        def phase(tag, fn, *args):
            with span(tag):
                t0 = time.perf_counter()
                out = fn(*args)
                sync(out)
                self._note_phase(plane_num, tag, time.perf_counter() - t0)
            return out

        return phase

    # ------------------------------------------------------------------
    def restart_path(self):
        return f"{self.cfg.OutputPath or '.'}/restart.npz"

    def save_restart(self, path=None):
        """The npz restart, the format the JAX package reads.  On a mesh the
        ranks' columns are gathered to rank 0, which writes the file a
        one-device run writes (so a run on n ranks resumes on any other
        number, or in the JAX package)."""
        from . import restart as rst

        if self.mesh is None:
            rst.write_restart(path or self.restart_path(), self.cfg,
                              self.rays, self.ray_nest, self.current_plane,
                              self.map_num)
            return
        full = self.mesh.gather_to(self.rays_packed,
                                   np.diff(self.ray_bounds), 0)
        if self._rank0():
            rst.write_restart(path or self.restart_path(), self.cfg,
                              soa.unpack(full.cpu().numpy()), self.ray_nest,
                              self.current_plane, self.map_num)
        self.mesh.barrier()

    def sharded_restart_path(self):
        return f"{self.cfg.OutputPath or '.'}/restart_sharded"

    def save_restart_sharded(self, path=None):
        """The shard-parallel checkpoint (restart.write_restart_sharded):
        each rank writes its own ray columns and its slice of the nest
        index, rank 0 the metadata; no ray data moves between ranks.  The
        counterpart of the JAX driver's save_restart_orbax."""
        from . import restart as rst

        r = 0 if self.mesh is None else self.mesh.rank
        c0, c1 = int(self.ray_bounds[r]), int(self.ray_bounds[r + 1])
        nest = None if self._ray_nest is None else self._ray_nest[c0:c1]
        rst.write_restart_sharded(
            path or self.sharded_restart_path(), self.cfg, self.rays_packed,
            nest, self.current_plane, self.map_num, self.ray_bounds, r,
            self.mesh)

    def load_restart_sharded(self, path=None):
        """Resume from a sharded checkpoint saved on ANY number of ranks:
        each rank reads only the parts of the shards that overlap its own
        columns, straight to its device, in the run's dtype; the nest index
        (None on the full sky), current_plane and map_num as load_restart
        sets them.  The counterpart of the JAX driver's
        load_restart_orbax."""
        from . import restart as rst

        (self.rays_packed, self._ray_nest, self.current_plane,
         self.map_num) = rst.read_restart_sharded(
            path or self.sharded_restart_path(), self.cfg, self._columns,
            self._np_dtype, self.device)

    def load_restart(self, path=None):
        """Resume from an npz restart (any writer's); on a mesh each rank
        reads the file and keeps its columns."""
        from . import restart as rst

        rays, nest, self.current_plane, self.map_num = rst.read_restart(
            path or self.restart_path(), self.cfg, self._np_dtype)
        dev = self.device if self.mesh is None else "cpu"
        packed = soa.pack(type(rays)(*(torch.as_tensor(x, device=dev)
                                       for x in rays)))
        self.rays_packed = (packed if self.mesh is None
                            else self._my_columns(packed.numpy()))
        self._columns(packed.shape[1])
        self._ray_nest = nest

    def load_legacy_restart(self, restart_dir=None):
        """Resume from a REFERENCE run's binary restart.<task> files
        (restart.c:18-219), the interop path of the CMB mode
        (propagate_to_cmb_from_restart.c).  Validates the layout-critical
        config fields as the reference does (restart.c:88-124) and raises
        ValueError on a mismatch.  The rays are stored in RING order of
        their pixels, as a box's are (the JAX package keeps the file's NEST
        order), with _ray_nest set even on the full sky: run() then takes
        the cut-sky galaxy search and the lens maps' scatter path."""
        from .io import legacy_restart as lr

        meta, rays = lr.read_legacy_restart(restart_dir
                                            or self.cfg.OutputPath or ".")
        cfg = self.cfg
        for f in ("bundleOrder", "rayOrder", "OmegaM", "maxComvDistance",
                  "NumLensPlanes", "minRa", "maxRa", "minDec", "maxDec"):
            if not np.isclose(float(meta[f]), float(getattr(cfg, f))):
                raise ValueError(
                    f"legacy restart incompatible: {f} = {meta[f]} in file, "
                    f"{getattr(cfg, f)} in config (restart.c:88-124)")
        packed, nest = lr.legacy_rays_to_packed(meta, rays,
                                                dtype=self._np_dtype)
        order = np.argsort(hp.nest2ring(nest, cfg.rayOrder), kind="stable")
        self.rays_packed = self._my_columns(packed[:, order])
        self._ray_nest = nest[order]
        self.current_plane = int(meta["CurrentPlaneNum"])
        self.map_num = int(meta["CurrentMapNum"])

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

    def _lens_map_sums(self, order):
        """The [7, npix_map] lens-map sums of the rays at map order `order`
        (on a mesh: reduced over the ranks onto rank 0, None on the
        others)."""
        if self.mesh is None:
            return lm.accum_lens_map_packed(self.rays_packed, self._ray_nest,
                                            self.cfg.rayOrder, order)
        return lm.accum_lens_map_sharded(self.mesh, self.rays_packed,
                                         self._ray_nest, self.ray_bounds,
                                         self.cfg.rayOrder, order)

    def _write_map_outputs(self):
        """Accumulate the lens maps on the rays' device (only the [7,
        npix_map] sums reach the host) and write Convergence_ and Rays_
        (rank 0 on a mesh)."""
        order = self._map_order()
        stacked = self._lens_map_sums(order)
        if stacked is None:
            return None
        accum = lm.LensMapAccum.from_stacked(stacked)
        return lm.write_map_outputs(accum, order, self.cfg.OutputPath or ".",
                                    self.map_num)

    def run(self, progress=True, start_time=None):
        """Plane loop with galaxy images, lens maps and wall-time restarts
        (reference raytrace.c:131-371): before each plane's step the images
        of the sources in its radial bin (GalsFileList; written per plane
        when GalOutputName is set); after each MapRedshiftList plane the
        lens maps (when OutputPath is set), and the ray files before them
        with MaxResMap and RayOutputName; the sharded checkpoint
        (save_restart_sharded, OutputPath/restart_sharded) every
        WallTimeBetweenRestart seconds and before the WallTimeLimit; at the
        end, the ray files (RayOutputName), the checkpoint and the timing.0
        rows."""
        cfg = self.cfg
        if self.rays_packed is None:
            self.init_rays()
        map_planes = self._map_planes()
        if map_planes and cfg.OutputPath:
            lm.check_map_order(cfg.rayOrder, self._map_order())
        search = self._galaxy_search() if cfg.GalsFileList else None
        t_start = start_time if start_time is not None else time.perf_counter()
        t_last_restart = t_start
        for p in range(self.current_plane, cfg.NumLensPlanes):
            collect = search(p) if search is not None else None
            self.step(p)
            if collect is not None:
                tgs = time.perf_counter()
                self._write_images(collect(), p)
                if cfg.Profile:
                    self._note_phase(p, "GRIDSEARCH",
                                     time.perf_counter() - tgs)
            progress = progress and self._rank0()
            if progress:
                pp = plane_params(cfg, self.cosmo, p)
                print(f"plane {p:4d}/{cfg.NumLensPlanes} "
                      f"[dist={pp.rad:.2f} Mpc/h, z={pp.zlens:.2f}] "
                      f"{self.timings[-1][1]:.3f}s", file=sys.stderr)
            if p in map_planes and cfg.OutputPath:
                tio = time.perf_counter()
                if cfg.MaxResMap and cfg.RayOutputName:
                    self.write_rays()
                self._write_map_outputs()
                self.map_num += 1
                if cfg.Profile:
                    self._note_phase(p, "RAYIO", time.perf_counter() - tio)
            now = time.perf_counter()
            step_t = self.timings[-1][1]
            if cfg.OutputPath and self._agree(
                    now - t_last_restart > cfg.WallTimeBetweenRestart):
                self.save_restart_sharded()
                if cfg.Profile:
                    self._note_phase(p, "RESTART", time.perf_counter() - now)
                t_last_restart = now
            if self._agree(now - t_start > cfg.WallTimeLimit - 5.0 * step_t):
                # graceful preemption (raytrace.c:143-149)
                if cfg.OutputPath:
                    self.save_restart_sharded()
                return
        if cfg.OutputPath and cfg.RayOutputName:
            self.write_rays()
        if cfg.OutputPath:
            self.save_restart_sharded()
            if self._rank0():
                self.write_timing()

    def write_rays(self):
        """The rays' files <RayOutputName><map_num>.<file> in OutputPath
        (io/rayio.py), from the packed buffer on its device."""
        from .io import rayio

        return rayio.write_rays_sharded(self.cfg, self.rays_packed,
                                        self._ray_nest, self.map_num,
                                        mesh=self.mesh,
                                        bounds=(None if self.mesh is None
                                                else self.ray_bounds))

    def _galaxy_search(self):
        """The source catalog's search, dispatched as calclens_tpu/
        driver.py dispatches it (one device): full-sky RING-ordered rays
        take the device search on the ray grid, a box (or a legacy
        restart, whose rays carry _ray_nest) the device search with its
        rows' RING pixels unless CALCLENS_GALS_DEVICE=0, anything else
        (a box with BornApprx included) the host-prep find_images over the
        GridSearchTables; BornApprx on the full sky interpolates A at the
        sources (find_images_born).  Returns search(p): the images of plane
        p's sources are found (or, for the device search, queued, unless
        CALCLENS_GALS_ASYNC=0) before its step; it returns the collect()
        to call after the step, or None when the images are written.

        On a mesh, full-sky rays take the sharded search (gridsearch.
        find_images_sharded, find_images_born_sharded: each rank images the
        sources whose central RING pixel it holds, over its columns and a
        halo of its neighbours'); other rays are gathered whole and rank 0
        runs the one-device dispatch.  Rank 0 writes the images."""
        from .gals import gridsearch as gs
        from .gals import io as galsio

        cfg = self.cfg
        gal_pos, gal_idx = galsio.read_source_gals(cfg.GalsFileList)
        tab = tables = n2i = ring_rows = None
        if self._ray_nest is None:
            # device search: ray index == RING pixel
            tab = torchhp.InterpTables(cfg.rayOrder)
        elif (not cfg.BornApprx
              and os.environ.get("CALCLENS_GALS_DEVICE", "1") != "0"):
            # cut sky: the rows are the box's pixels in RING order, and a
            # sorted row -> RING pixel table translates the candidates'
            # taps on the device (gridsearch._rows_of_pix)
            tab = torchhp.InterpTables(cfg.rayOrder)
            ring_rows = hp.nest2ring(self._ray_nest, cfg.rayOrder)
            if not np.all(np.diff(ring_rows) > 0):
                raise ValueError("the rays of a cut-sky galaxy search must "
                                 "be in increasing RING pixel order")
        else:
            # candidate window >= the reference's galImageSearchRad of 10
            # ray pixels (config.c:222-225): half-width ~1.5 * 2^expand;
            # each NEST pixel maps to its row, -1 where no ray is (the JAX
            # driver passes the full sky's ring_of_nest here)
            tables = gs.GridSearchTables(cfg.rayOrder, expand=3)
            n2i = np.full(len(tables.ring_of_nest), -1, np.int64)
            n2i[self._ray_nest] = np.arange(len(self._ray_nest))
        binL = cfg.maxComvDistance / cfg.NumLensPlanes

        def search(p):
            ppos, pidx = gs.select_plane_gals(gal_pos, gal_idx, p, binL,
                                              cfg.NumLensPlanes,
                                              cfg.maxComvDistance)
            if not len(ppos):
                return None
            tgs = time.perf_counter()
            pp = plane_params(cfg, self.cosmo, p)
            args = (ppos, pidx, pp.rad, pp.rad_minus1)
            collect = images = None
            packed = self.rays_packed
            if self.mesh is not None and self._ray_nest is None:
                fn = (gs.find_images_born_sharded if cfg.BornApprx
                      else gs.find_images_sharded)
                images = fn(cfg, tab, packed, *args, self.mesh)
                packed = None
            elif self.mesh is not None:
                packed = self.packed_global()
                if not self._rank0():
                    packed = None
            if packed is None:
                pass
            elif cfg.BornApprx and tab is not None:
                images = gs.find_images_born(cfg, tab, packed, *args)
            elif tab is not None:
                # the search reads the pre-step buffer; the step writes a
                # new one, so collect() can still fall back to this one
                collect = gs.find_images_device_async(
                    cfg, tab, packed, *args, ring_rows=ring_rows)
                if (os.environ.get("CALCLENS_GALS_ASYNC", "1") == "0"
                        or self.mesh is not None):
                    images, collect = collect(), None
                elif cfg.Profile:
                    # Profile: the column holds the search's device time
                    sync(self.rays_packed)
            else:
                images = gs.find_images(cfg, tables, packed, *args,
                                        nest2index=n2i)
            if images is not None:
                self._write_images(images, p)
            if cfg.Profile:
                self._note_phase(p, "GRIDSEARCH", time.perf_counter() - tgs)
            return collect

        return search

    def _write_images(self, images, plane_num):
        if self.cfg.GalOutputName and self._rank0():
            from .gals import io as galsio

            galsio.write_image_gals(self.cfg, images, plane_num)

    # ------------------------------------------------------------------
    def propagate_to_cmb(self, z_cmb=1100.0, map_order=None):
        """Propagate the current rays to chi(z_cmb) and return the
        convergence accumulator at map_order (reference
        propagate_to_cmb_from_restart.c:184-492).  A map cannot be finer
        than the ray grid: that raises ValueError before any work."""
        cfg = self.cfg
        map_order = map_order or lm.CMB_MAP_ORDER
        lm.check_map_order(cfg.rayOrder, map_order)
        # plane radii as the reference's CMB continuation sets them from
        # the restart's CurrentPlaneNum (set_plane_distances,
        # propagate_to_cmb_from_restart.c:120-136); a particle-free plane
        # with the radial alpha == 0 branch
        binL = cfg.maxComvDistance / cfg.NumLensPlanes
        p = self.current_plane
        pp = PlaneParams(
            plane_num=p,
            rad_minus1=0.0 if p < 1 else (p - 1.0) * binL + binL / 2.0,
            rad=p * binL + binL / 2.0,
            rad_plus1=float(lm.comoving_distance_2f1(z_cmb, cfg.OmegaM)),
            densfact=0.0, backdens=0.0, zlens=z_cmb)
        self.rays_packed = empty_plane_step_packed(
            cfg.BornApprx, self.rays_packed,
            plane_scalars(pp, self.dtype, self.device), radial=True)
        sync(self.rays_packed)
        # only the [7, npix_map] sums reach the host (the reference
        # likewise reduces the order-12 map only, :440-492)
        stacked = self._lens_map_sums(map_order)
        return None if stacked is None else lm.LensMapAccum.from_stacked(
            stacked)

    def write_timing(self):
        """Per-plane step times (the reference's timing.0 rows,
        raytrace.c:54-64, 338-343).  In cfg.Profile mode the rows carry the
        reference-style per-phase columns (Deposit, SHTSolve = analysis +
        filter, SHT = derivative synthesis, RayProp = interpolation +
        propagation, PartIO, GridSearch, RayIO, Restart) and the profiler's
        totals go to the `timing` file."""
        path = os.path.join(self.cfg.OutputPath, "timing.0")
        phases = ("DEPOSIT", "SHTSOLVE", "SHT", "RAYPROP", "PARTIO",
                  "GRIDSEARCH", "RAYIO", "RESTART")
        prow = dict(self.phase_rows)
        with open(path, "w") as fp:
            if self.cfg.Profile:
                fp.write("# plane StepTime " +
                         " ".join(t.title() for t in phases) + "\n")
                for p, t in self.timings:
                    r = prow.get(p, {})
                    fp.write(f"{p} {t:.6f} " +
                             " ".join(f"{r.get(k, 0.0):.6f}" for k in phases)
                             + "\n")
            else:
                fp.write("# plane StepTime[s]\n")
                for p, t in self.timings:
                    fp.write(f"{p} {t:.6f}\n")
        if self.cfg.Profile:
            self.profiler.write(os.path.join(self.cfg.OutputPath, "timing"))
