"""Cut-sky runs and precomputed mass-map planes through the port, against
calclens_tpu on the same numpy inputs (float64): the vacuum mask and the
box's ray pixels, a 3-plane CIC trace in a box from init_rays and 2-plane
traces of SPH and NGP in boxes 0 and 2, the interior
check of tests/test_cutsky_physics.py, a cut-sky restart, and
UseHEALPixLensPlaneMaps planes as tests/test_mapplanes_cutsky.py asserts
them.

Tolerances: the mask and the ray pixels exact; traces 1e-9 of each
quantity's max per plane (two FFT libraries and summation orders through
the SHT, as tests/test_torch_raytrace.py); the physics checks keep the JAX
tests' own bounds."""
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.config import RayTraceConfig
from calclens_tpu import driver as jdriver
from calclens_tpu.healpix import core as hp
from calclens_tpu.testing import pointmass as pm
from calclens_tpu_torch import driver as tdriver
from calclens_tpu_torch.io import healpix_maps as tmaps

GROUPS = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))

BOXES = (dict(minRa=30.0, maxRa=60.0, minDec=-10.0, maxDec=20.0),
         dict(minRa=0.0, maxRa=90.0, minDec=0.0, maxDec=90.0),
         dict(minRa=100.0, maxRa=340.0, minDec=-90.0, maxDec=-25.0))


def _row_err(got, ref):
    """Max over packed rows of |got - ref| / max |ref| of the row's
    quantity (n, beta, A, Aprev, alpha, U, phi)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    worst = 0.0
    for a, b in GROUPS:
        scale = np.abs(ref[a:b]).max() + 1e-300
        worst = max(worst, float(np.abs(got[a:b] - ref[a:b]).max() / scale))
    return worst


@pytest.mark.parametrize("order", [5, 6, 7, 8])
@pytest.mark.parametrize("box", range(len(BOXES)))
def test_vacuum_mask_and_active_ray_pixels_match_jax(box, order):
    """Both packages' methods on the same configuration (they read only
    the configuration, and the port's the device): the float32 mask and the
    box's NEST pixels, in RING order, are the same bits."""
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=order, rayOrder=order, bundleOrder=3,
                         **BOXES[box]).finalize()
    jself = types.SimpleNamespace(cfg=cfg)
    tself = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    ref = np.asarray(jdriver.Raytracer.vacuum_mask(jself))
    got = tdriver.Raytracer.vacuum_mask(tself)
    assert got.dtype == torch.bool and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < len(ref)
    pj = jdriver.Raytracer.active_ray_pixels(jself)
    pt = tdriver.Raytracer.active_ray_pixels(tself)
    np.testing.assert_array_equal(pt, pj)
    assert np.all(np.diff(hp.nest2ring(pt, order)) > 0)
    th, ph = hp.pix2ang_nest(pt, order)
    ra, dec = hp.ang2radec(th, ph)
    b = BOXES[box]
    assert np.all((ra >= b["minRa"]) & (ra <= b["maxRa"])
                  & (dec >= b["minDec"]) & (dec <= b["maxDec"]))


def test_vacuum_mask_chunks_and_full_sky(monkeypatch):
    """The mask computed in chunks equals the one-pass mask; the full sky
    has none."""
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                         SHTOrder=6, rayOrder=5, bundleOrder=2,
                         **BOXES[0]).finalize()
    tself = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    whole = tdriver.Raytracer.vacuum_mask(tself)
    monkeypatch.setattr(tdriver, "VACMASK_CHUNK", 1000)
    assert torch.equal(tdriver.Raytracer.vacuum_mask(tself), whole)
    full = RayTraceConfig(OmegaM=0.3, maxComvDistance=2000.0,
                          NumLensPlanes=8, SHTOrder=4, rayOrder=4,
                          bundleOrder=2).finalize()
    assert tdriver.Raytracer(full, device="cpu").vacmask is None


# ----------------------------------------------------------------------------
# a CIC trace in a box from init_rays, SHTOrder 6 / rayOrder 5
# ----------------------------------------------------------------------------

def _box_cfg(**kw):
    base = dict(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
                SHTOrder=6, rayOrder=5, bundleOrder=2, Precision="f64",
                DepositScheme="CIC", **BOXES[0])
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _plane_particles(p, seed=31, n=3000):
    rng = np.random.default_rng(seed + p)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rad = (p + rng.uniform(0.0, 1.0, size=(n, 1))) * 250.0
    return v * rad, rng.uniform(1e12, 5e13, size=n)


@pytest.fixture(scope="module")
def box_trace(tmp_path_factory):
    """Both drivers from init_rays over planes 0-2 (plane 1 empty); the
    port's state after each plane and its restart after plane 1."""
    tmp = tmp_path_factory.mktemp("cutsky_restart")
    cfg = _box_cfg()
    jrt = jdriver.Raytracer(cfg)
    trt = tdriver.Raytracer(cfg, device="cpu")
    jrt.init_rays()
    trt.init_rays()
    start = (trt.rays_packed.numpy().copy(), np.asarray(jrt.rays_packed))
    errs, states = [], []
    for p in (0, 1, 2):
        pos, mass = _plane_particles(p) if p != 1 else ([], [])
        jrt.step(p, pos=pos, mass=mass)
        trt.step(p, pos=pos, mass=mass)
        errs.append(_row_err(trt.rays_packed.numpy(), jrt.rays_packed))
        states.append(trt.rays_packed.clone())
        if p == 1:
            trt.save_restart(str(tmp / "restart.npz"))
    return dict(cfg=cfg, jrt=jrt, trt=trt, start=start, errs=errs,
                states=states, restart=str(tmp / "restart.npz"))


def test_cutsky_cic_trace_matches_jax(box_trace):
    t = box_trace
    jrt, trt = t["jrt"], t["trt"]
    # the box's rays, built from float64 pixel vectors on both sides
    np.testing.assert_array_equal(trt.ray_nest, jrt.ray_nest)
    assert trt.rays_packed.shape == (21, len(jrt.ray_nest)) \
        and len(jrt.ray_nest) < 12 * 4**5
    np.testing.assert_array_equal(*t["start"])
    np.testing.assert_array_equal(trt.vacmask.numpy(),
                                  np.asarray(jrt.vacmask))
    assert max(t["errs"]) < 1e-9, t["errs"]
    assert np.abs(trt.rays_packed[14:16].numpy()).max() > 0  # deflected
    for a, b in zip(trt.rays, jrt.rays):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-9 * np.abs(b).max() + 1e-300)


@pytest.mark.parametrize("scheme,box", [("SPH", 0), ("NGP", 2),
                                        ("SPH", 2)])
def test_cutsky_trace_matches_jax(scheme, box):
    """The box trace of the other deposits and of the south cap: SPH in
    box 0, NGP and SPH in box 2 (ra 100-340, dec -90 to -25), both drivers
    from init_rays over planes 0 and 1 at SHTOrder 5 / rayOrder 4, the
    port on one torch thread; the same bound as the CIC trace (1e-9 of
    each quantity's max per plane).  The deposits sum in a fixed order
    (ops/deposit.add_at); SPH in a box takes every branch of the bucketed
    deposit (bucket 0 carries -backdens on the live pixels).  Most of the
    time is the JAX step's first compile (~15 s NGP, ~25 s SPH with JAX's
    compilation cache cold, at any order)."""
    kw = dict(BOXES[box], DepositScheme=scheme, SHTOrder=5, rayOrder=4)
    if scheme == "SPH":
        kw["ComvSmoothingScale"] = 15.0
    cfg = _box_cfg(**kw)
    jrt = jdriver.Raytracer(cfg)
    trt = tdriver.Raytracer(cfg, device="cpu")
    jrt.init_rays()
    trt.init_rays()
    np.testing.assert_array_equal(trt.ray_nest, jrt.ray_nest)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        errs = []
        for p in (0, 1):
            pos, mass = _plane_particles(p)
            jrt.step(p, pos=pos, mass=mass)
            trt.step(p, pos=pos, mass=mass)
            errs.append(_row_err(trt.rays_packed.numpy(), jrt.rays_packed))
    finally:
        torch.set_num_threads(threads)
    assert max(errs) < 1e-9, errs
    assert np.abs(trt.rays_packed[14:16].numpy()).max() > 0  # deflected


def test_cutsky_restart_roundtrip(box_trace, tmp_path):
    """The restart written after plane 1 resumes in a new Raytracer (with
    its vacuum mask) and gives plane 2's rays bit for bit; the JAX package
    reads the same file."""
    t = box_trace
    cfg = t["cfg"]
    trt = tdriver.Raytracer(cfg, device="cpu")
    trt.load_restart(t["restart"])
    assert trt.current_plane == 2
    np.testing.assert_array_equal(trt.ray_nest, t["trt"].ray_nest)
    assert torch.equal(trt.rays_packed, t["states"][1])
    trt.step(2, *_plane_particles(2))
    assert torch.equal(trt.rays_packed, t["states"][2])
    jrt = jdriver.Raytracer(cfg)
    jrt.load_restart(t["restart"])
    np.testing.assert_array_equal(np.asarray(jrt.rays_packed),
                                  t["states"][1].numpy())
    np.testing.assert_array_equal(jrt._ray_nest, trt.ray_nest)
    # load_state of a box takes the box's rays, not the full sky's
    trt.load_state(t["states"][1].numpy(), 2)
    np.testing.assert_array_equal(trt.ray_nest, t["trt"].ray_nest)
    with pytest.raises(ValueError, match="expected"):
        trt.load_state(np.zeros((21, 12 * 4**5)), 2)


def test_jax_load_restart_drops_the_vacuum_mask(box_trace):
    """A JAX-side difference (ROADMAP Queue 3): the JAX driver sets its
    vacuum mask in init_rays only, so a cut-sky run resumed with
    load_restart traces its next planes with no mask.  The port computes
    the mask when the Raytracer is built."""
    t = box_trace
    jrt = jdriver.Raytracer(t["cfg"])
    jrt.load_restart(t["restart"])
    assert getattr(jrt, "vacmask", None) is None
    trt = tdriver.Raytracer(t["cfg"], device="cpu")
    trt.load_restart(t["restart"])
    assert trt.vacmask is not None and bool(trt.vacmask.any())


# ----------------------------------------------------------------------------
# tests/test_cutsky_physics.py through the port, SHTOrder 6 / rayOrder 5
# ----------------------------------------------------------------------------

RA0, DEC0 = 32.0, 14.0


def _pm_trace(tmp_path, box):
    kw = dict(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        LensPlanePath=str(tmp_path), LensPlaneName="pmplane",
        SHTOrder=6, rayOrder=5, bundleOrder=3,
        partMass=5.0e16, raPointMass=RA0, decPointMass=DEC0,
        radPointMass=625.0, PointMassTest=True, Precision="f64",
        ComvSmoothingScale=1.0, SmoothingBeamFWHM=0.048,
    )
    if box:
        kw.update(minRa=RA0 - 20.0, maxRa=RA0 + 20.0,
                  minDec=DEC0 - 20.0, maxDec=DEC0 + 20.0)
    cfg = RayTraceConfig(**kw).finalize()
    mass_vec, mass_plane = pm.make_pointmass_planes(
        cfg, snap_to_pixel_order=cfg.SHTOrder)
    rt = tdriver.Raytracer(cfg, device="cpu")
    rt.init_rays()
    for p in range(mass_plane + 1):
        rt.step(p)
    return cfg, rt


def test_cutsky_patch_matches_fullsky_interior_through_port(tmp_path):
    """tests/test_cutsky_physics.py's check and bounds, one order lower
    (the beam widened with the pixel; the float64 twins at order 7 take
    minutes on a loaded CPU): rays at least 5 degrees inside the box agree
    with the full-sky run's."""
    cfg_f, rt_f = _pm_trace(tmp_path / "full", box=False)
    cfg_c, rt_c = _pm_trace(tmp_path / "cut", box=True)
    assert rt_c.vacmask is not None and rt_f.vacmask is None
    assert len(rt_c.ray_nest) < rt_f.rays_packed.shape[1]
    assert bool(rt_c.vacmask.any())
    pix_c = rt_c.ray_nest
    ra_c, dec_c = hp.ang2radec(*hp.pix2ang_nest(pix_c, cfg_c.rayOrder))
    interior = ((ra_c > RA0 - 15) & (ra_c < RA0 + 15)
                & (dec_c > DEC0 - 15) & (dec_c < DEC0 + 15))
    assert interior.sum() > 100
    lut = np.full(12 * 4**cfg_f.rayOrder, -1, np.int64)
    lut[rt_f.ray_nest] = np.arange(len(rt_f.ray_nest))
    sel_f = lut[pix_c[interior]]
    assert np.all(sel_f >= 0)
    rays_c, rays_f = rt_c.rays, rt_f.rays
    for field, tol in (("n", 1e-6), ("alpha", 5e-3), ("A", 1e-5),
                       ("phi", 1e-5)):
        a = np.asarray(getattr(rays_c, field))[interior]
        b = np.asarray(getattr(rays_f, field))[sel_f]
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a, b, atol=tol * scale, err_msg=field)
    assert np.abs(np.asarray(rays_c.alpha)[interior]).max() > 1e-6


# ----------------------------------------------------------------------------
# UseHEALPixLensPlaneMaps (tests/test_mapplanes_cutsky.py), SHTOrder 6 /
# rayOrder 5
# ----------------------------------------------------------------------------

def test_mass_map_planes_match_jax_and_particles(tmp_path):
    """A point mass fed as a precomputed count map, in a box (with the
    vacuum mask): the port's mass-map planes against the JAX package's
    (1e-9 per plane), and against the port's own particle path (both NGP at
    the same pixel) with tests/test_mapplanes_cutsky.py's bounds."""
    common = dict(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        SHTOrder=6, rayOrder=5, bundleOrder=3,
        partMass=5.0e16, raPointMass=32.0, decPointMass=14.0,
        radPointMass=625.0, PointMassTest=True, Precision="f64",
        SmoothingBeamFWHM=0.05,
        minRa=10.0, maxRa=60.0, minDec=-10.0, maxDec=40.0)
    cfg_p = RayTraceConfig(LensPlanePath=str(tmp_path), LensPlaneName="pm",
                           **common).finalize()
    mass_vec, mass_plane = pm.make_pointmass_planes(
        cfg_p, snap_to_pixel_order=cfg_p.SHTOrder)
    npix = 12 * 4**cfg_p.SHTOrder
    pix = int(hp.vec2pix_ring(np.asarray(mass_vec), cfg_p.SHTOrder))
    for p in range(8):
        counts = np.zeros(npix, np.float32)
        if p == mass_plane:
            counts[pix] = 1.0
        tmaps.write_plane_map(str(tmp_path / "maps"), "massmap", p, counts)
    cfg_m = RayTraceConfig(
        HEALPixLensPlaneMapPath=str(tmp_path / "maps"),
        HEALPixLensPlaneMapName="massmap",
        HEALPixLensPlaneMapOrder=common["SHTOrder"], **common).finalize()
    assert cfg_m.UseHEALPixLensPlaneMaps

    jrt = jdriver.Raytracer(cfg_m)
    jrt.init_rays()
    trt_m = tdriver.Raytracer(cfg_m, device="cpu")
    trt_p = tdriver.Raytracer(cfg_p, device="cpu")
    start = np.asarray(jrt.rays_packed)
    for rt in (trt_m, trt_p):
        rt.load_state(start, 0)
    for p in range(mass_plane + 1):
        jrt.step(p)
        trt_m.step(p)
        trt_p.step(p)
        assert _row_err(trt_m.rays_packed.numpy(), jrt.rays_packed) < 1e-9, p
    np.testing.assert_allclose(np.asarray(trt_m.rays.alpha),
                               np.asarray(trt_p.rays.alpha), atol=1e-12)
    np.testing.assert_allclose(np.asarray(trt_m.rays.n),
                               np.asarray(trt_p.rays.n), atol=1e-9)
    assert np.abs(np.asarray(trt_m.rays.alpha)).max() > 1e-6
