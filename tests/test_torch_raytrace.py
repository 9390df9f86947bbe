"""Parity of the port's ray side, plane step and driver with calclens_tpu on
the same numpy inputs (float64 unless stated), the point-mass analytic test
through the port, and the npz restart across the two packages.

Tolerances: per packed row, relative to the reference row's max |value|:
1e-12 for pure ray-side arithmetic (a few ulps through trig chains), 1e-9
for anything that passes through the SHT solve (two FFT libraries, other
summation orders, amplified by the derivative maps); float32 as stated at
each test."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.config import RayTraceConfig
from calclens_tpu import driver as jdriver
from calclens_tpu import poisson as jpoisson
from calclens_tpu.healpix import jaxhp
from calclens_tpu.healpix import core as hp
from calclens_tpu.ops import deposit as jdep
from calclens_tpu.rays import soa as jsoa
from calclens_tpu.testing import pointmass as pm
from calclens_tpu_torch import driver as tdriver
from calclens_tpu_torch import poisson as tpoisson
from calclens_tpu_torch import restart as trestart
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.ops import deposit as tdep
from calclens_tpu_torch.raytrace import main as port_main
from calclens_tpu_torch.rays import soa as tsoa


def _row_err(got, ref):
    """Max over rows of |got - ref| / scale, for [R, N] arrays.  A packed
    ray buffer's rows are scaled by the max |value| of their quantity (n,
    beta, A, Aprev, alpha, U, phi), so an off-diagonal that is exactly 0
    up to roundoff is measured against its matrix; other arrays row by
    row."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mx = np.max(np.abs(ref), axis=1)
    if ref.shape[0] == 21:
        groups = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20),
                  (20, 21))
        mx = np.concatenate([np.full(b - a, mx[a:b].max()) for a, b in groups])
    return float(np.max(np.max(np.abs(got - ref), axis=1) / (mx + 1e-300)))


def _perturbed_rays(order, wpm1, seed, dtype):
    """Full-sky packed rays moved off the pixel centres, with random
    direction, A, Aprev, alpha and U rows."""
    rng = np.random.default_rng(seed)
    npix = 12 * 4**order
    v = hp.pix2vec_ring(np.arange(npix), order).T  # [3, npix]
    v = v + 0.05 * rng.normal(size=v.shape) / (1 << order)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    r = np.zeros((21, npix))
    r[0:3] = v * wpm1
    b = v + 0.01 * rng.normal(size=v.shape)
    r[3:6] = b / np.linalg.norm(b, axis=0, keepdims=True)
    r[6:14] = np.tile(np.array([1.0, 0, 0, 1.0])[:, None], (2, npix)) \
        + 0.01 * rng.normal(size=(8, npix))
    r[14:16] = 1e-3 * rng.normal(size=(2, npix))
    r[16:20] = 1e-3 * rng.normal(size=(4, npix))
    r[20] = rng.normal(size=npix)
    return r.astype(dtype)


# float32: an azimuth weight is the fractional part of phi / dphi, a number
# up to 4 nside, so it carries 4 nside ulps of absolute rounding; on these
# rough random maps that is 4 * 128 * eps ~ 6e-5 of a row's range at order 5
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 4 * 128 * 1.19e-7)])
def test_interp_and_prop_chunk_matches_jax(dtype, tol):
    order_map, order_ray = 5, 4
    npix = 12 * 4**order_map
    rng = np.random.default_rng(1)
    # lensing-sized fields: phi ~1e-4, deflections ~1e-3 rad, shear ~1e-2
    scale = np.array([1e-4, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2])[:, None]
    maps = (rng.normal(size=(6, npix)) * scale).astype(dtype)
    wp, wpm1, wpm2 = (np.asarray(x, dtype) for x in (750.0, 625.0, 375.0))
    r = _perturbed_rays(order_ray, 625.0, 2, dtype)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    for born in (False, True):
        ref = jsoa.interp_and_prop_chunk(
            jaxhp.InterpTables(order_map, jdt), jnp.asarray(maps),
            jnp.asarray(r), wp, wpm1, wpm2, born)
        got = tsoa.interp_and_prop_chunk(
            torchhp.InterpTables(order_map),
            tsoa.with_pixel_ids(torch.tensor(maps)),
            torch.tensor(r), *(torch.tensor(x) for x in (wp, wpm1, wpm2)),
            born)
        assert got.dtype == tdt
        assert _row_err(got.numpy(), ref) < tol, born


@pytest.mark.parametrize("born,radial", [(False, False), (True, False),
                                         (False, True)])
def test_prop_rows_matches_jax(born, radial):
    r = _perturbed_rays(4, 625.0, 3, np.float64)
    r[14:16, ::7] = 0.0  # some unbent rays: the radial branch
    scal = (750.0, 625.0, 375.0)
    rows = (14, 15, 16, 17, 18, 19, 20)
    ref = jsoa._prop_rows(jnp.asarray(r), *(jnp.asarray(r[i]) for i in rows),
                          *scal, born, radial_when_straight=radial)
    tr = torch.tensor(r)
    got = tsoa._prop_rows(tr, *(tr[i] for i in rows),
                          *(torch.tensor(x, dtype=torch.float64)
                            for x in scal), born, radial_when_straight=radial)
    assert _row_err(got.numpy(), ref) < 1e-12
    got2 = tsoa.prop_only_chunk(torch.tensor(r),
                                *(torch.tensor(x, dtype=torch.float64)
                                  for x in scal), born,
                                radial_when_straight=radial)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_init_deposit_and_scale_match_jax(dtype):
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    ref = jsoa.init_packed_fullsky(4, jnp.asarray(125.0, jdt), 12 * 4**4, jdt)
    got = tsoa.init_packed_fullsky(4, 125.0, 12 * 4**4, "cpu", tdt)
    assert _row_err(got.numpy(), ref) < (1e-15 if dtype == np.float64
                                         else 1e-6)
    rng = np.random.default_rng(4)
    pos = (rng.normal(size=(5000, 3)) * 300.0).astype(dtype)
    mass = rng.uniform(1e11, 1e13, size=5000).astype(dtype)
    dj = np.asarray(jdep.deposit_ngp(5, jnp.asarray(pos), jnp.asarray(mass),
                                     12 * 4**5))
    dt_ = tdep.deposit_ngp(5, torch.tensor(pos), torch.tensor(mass),
                           12 * 4**5).numpy()
    # same pixels; only the summation order of colliding particles differs
    np.testing.assert_allclose(dt_, dj, rtol=10 * np.finfo(dtype).eps,
                               atol=0)
    assert np.isclose(dt_.sum(), mass.sum() / 1e10, rtol=1e-5)
    args = (jnp.asarray(3.0e-4, jdt), jnp.asarray(2.0e-3, jdt),
            4 * np.pi / (12 * 4**5))
    sj = np.asarray(jdep.scale_density(jnp.asarray(dj), *args))
    st = tdep.scale_density(torch.tensor(dj),
                            torch.tensor(3.0e-4, dtype=tdt),
                            torch.tensor(2.0e-3, dtype=tdt), args[2]).numpy()
    np.testing.assert_allclose(st, sj, rtol=4 * np.finfo(dtype).eps,
                               atol=4 * np.finfo(dtype).eps * np.abs(sj).max())


# ----------------------------------------------------------------------------
# plane step and multi-plane trace, SHTOrder 6 / rayOrder 5
# ----------------------------------------------------------------------------

def _trace_cfg(**kw):
    base = dict(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
                SHTOrder=6, rayOrder=5, bundleOrder=2, Precision="f64")
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _plane_particles(p, seed=7, n=3000):
    rng = np.random.default_rng(seed + p)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    binL = 1500.0 / 6
    rad = (p + rng.uniform(0.0, 1.0, size=(n, 1))) * binL
    return v * rad, rng.uniform(1e12, 5e13, size=n)


@pytest.fixture(scope="module")
def jax_tracer():
    """One JAX Raytracer for the module: its fused plane step compiles once
    per plan object."""
    rt = jdriver.Raytracer(_trace_cfg())
    rt.init_rays()
    return rt


def test_plane_step_packed_matches_jax(jax_tracer):
    jrt = jax_tracer
    trt = tdriver.Raytracer(jrt.cfg, device="cpu")
    cfg = jrt.cfg
    pp = jdriver.plane_params(cfg, jrt.cosmo, 2)
    start = np.array(np.asarray(jrt.rays_packed))
    start[14:21] = 1.0  # the step must zero the per-plane rows itself
    pos, mass = _plane_particles(2)
    pos_j, mass_j = jrt._pad_particles(pos, mass)
    scal_j = jpoisson.PlaneScalars(
        *(jnp.asarray(x, jnp.float64) for x in
          (pp.densfact, pp.backdens, pp.rad_plus1, pp.rad, pp.rad_minus1)))
    ref, maps_j = jpoisson.plane_step_packed(
        jrt.plan, jrt.tab, jnp.asarray(start), pos_j, mass_j, "NGP", False,
        True, scal_j, None, None)
    pos_t, mass_t = trt._pad_particles(pos, mass)
    held = torch.tensor(start)
    got, maps_t = tpoisson.plane_step_packed(
        trt.plan, trt.tab, held, pos_t, mass_t, False, True,
        tpoisson.plane_scalars(pp, torch.float64, "cpu"))
    # the caller's buffer is not touched (the per-plane rows are reset on a
    # copy)
    np.testing.assert_array_equal(held.numpy(), start)
    maps_ref = np.stack([np.asarray(x) for x in maps_j])
    assert _row_err(torch.stack(list(maps_t)).numpy(), maps_ref) < 1e-9
    assert _row_err(got.numpy(), ref) < 1e-9
    assert np.all(np.abs(ref[14:16]).max(axis=1) > 0)  # deflected


@pytest.mark.parametrize("synth,analysis", [("k2", "k1"), ("k3", "k4")])
def test_three_plane_trace_matches_jax_plane_by_plane(jax_tracer, synth,
                                                      analysis):
    """Both drivers start from the same packed state (load_state) and step
    three planes, an empty one among them; compared after every plane.  The
    port runs with either pair of Legendre kernels (their twins here)."""
    jrt = jax_tracer
    start = np.array(np.asarray(jrt.rays_packed))
    trt = tdriver.Raytracer(jrt.cfg, device="cpu")
    trt.plan.synth_kernel, trt.plan.analysis_kernel = synth, analysis
    trt.load_state(start, 1, 0)
    jrt.rays_packed = jnp.asarray(start)
    for p in (1, 2, 3):
        pos, mass = _plane_particles(p) if p != 2 else ([], [])
        jrt.step(p, pos=pos, mass=mass)
        trt.step(p, pos=pos, mass=mass)
        ref = np.asarray(jrt.rays_packed)
        assert _row_err(trt.rays_packed.numpy(), ref) < 1e-9, p
        assert trt.current_plane == jrt.current_plane == p + 1
    np.testing.assert_array_equal(trt.ray_nest, jrt.ray_nest)
    for a, b in zip(trt.rays, jrt.rays):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-9 * np.abs(b).max() + 1e-300)


def test_npz_restart_roundtrip_jax_port_jax(jax_tracer, tmp_path):
    jrt = jax_tracer
    assert trestart._COMPAT_FIELDS == __import__(
        "calclens_tpu.restart", fromlist=["x"])._COMPAT_FIELDS
    jrt.current_plane, jrt.map_num = 4, 1
    p1 = str(tmp_path / "jax.npz")
    jrt.save_restart(p1)
    trt = tdriver.Raytracer(jrt.cfg, device="cpu")
    trt.load_restart(p1)
    assert (trt.current_plane, trt.map_num) == (4, 1)
    np.testing.assert_array_equal(trt.rays_packed.numpy(),
                                  np.asarray(jrt.rays_packed))
    p2 = str(tmp_path / "port.npz")
    trt.save_restart(p2)
    with np.load(p1) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jrt2 = jdriver.Raytracer(jrt.cfg)
    jrt2.load_restart(p2)
    np.testing.assert_array_equal(np.asarray(jrt2.rays_packed),
                                  np.asarray(jrt.rays_packed))
    assert (jrt2.current_plane, jrt2.map_num) == (4, 1)
    bad = _trace_cfg(rayOrder=4)
    with pytest.raises(ValueError, match="rayOrder"):
        trestart.read_restart(p2, bad)


@pytest.mark.parametrize("field,value,slice_no", [
    ("SHTOnly", False, 11), ("ThreeDPot", True, 12),
    ("GalsFileList", "gals.txt", 8), ("DebugIO", True, 10),
    ("RayOutputName", "rays", 10), ("CMBLensing", 1, 9)])
def test_out_of_slice_config_raises(field, value, slice_no):
    """The configuration values of the slices ported after the main path,
    8 (galaxies), 9 (CMB mode), 10 (ray outputs, DebugIO), 11 (multigrid)
    and 12 (ThreeDPot), build a Raytracer: no configuration value is
    refused any longer."""
    cfg = _trace_cfg(**{field: value})
    assert slice_no in (8, 9, 10, 11, 12)
    assert tdriver.Raytracer(cfg, device="cpu").cfg is cfg


# ----------------------------------------------------------------------------
# point-mass analytic test through the port (tests/test_pointmass.py's
# configuration and tolerances)
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_pointmass(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pmtest_torch")
    cfg = RayTraceConfig(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        LensPlanePath=str(tmp), LensPlaneName="pmplane",
        SHTOrder=7, rayOrder=6, bundleOrder=3, partMass=5.0e16,
        raPointMass=32.0, decPointMass=14.0, radPointMass=625.0,
        PointMassTest=True, Precision="f64", ComvSmoothingScale=1.0,
        SmoothingBeamFWHM=0.024,
    ).finalize()
    mass_vec, mass_plane = pm.make_pointmass_planes(
        cfg, snap_to_pixel_order=cfg.SHTOrder)
    rt = tdriver.Raytracer(cfg, device="cpu")
    rt.init_rays()
    alpha = gamma = None
    for p in range(cfg.NumLensPlanes):
        rt.step(p)
        if p == mass_plane:
            alpha = np.array(rt.rays.alpha)
            nhat = np.array(rt.rays.n)
            nhat /= np.linalg.norm(nhat, axis=1, keepdims=True)
            gamma = np.arccos(np.clip(nhat @ mass_vec, -1, 1))
    return cfg, rt, mass_vec, mass_plane, alpha, gamma


def test_pointmass_deflection_through_port(port_pointmass):
    cfg, rt, mass_vec, mass_plane, alpha, gamma = port_pointmass
    pp = tdriver.plane_params(cfg, rt.cosmo, mass_plane)
    q = pm.charge(cfg, rt.cosmo, pp.rad)
    amag = np.linalg.norm(alpha, axis=1)
    bl = tdriver.gauss_beam(cfg.SmoothingBeamFWHM, rt.plan.lmax)
    sel = (gamma > 0.05) & (gamma < 0.5)
    ref_band = pm.alpha_bandlimited(gamma[sel], q, rt.plan.lmax, bl=bl)
    err = np.abs(amag[sel] - ref_band) / np.abs(ref_band)
    assert np.median(err) < 0.01, np.median(err)
    assert np.percentile(err, 95) < 0.05
    sel2 = (gamma > 0.15) & (gamma < 0.6)
    err2 = np.abs(amag[sel2] - pm.alpha_exact(gamma[sel2], q)) \
        / pm.alpha_exact(gamma[sel2], q)
    assert np.median(err2) < 0.02, np.median(err2)
    # direction: alpha points at the mass
    n = np.array(rt.rays.n)
    nhat = n / np.linalg.norm(n, axis=1, keepdims=True)
    sel = (gamma > 0.1) & (gamma < 0.4)
    phihat = np.stack([-nhat[:, 1], nhat[:, 0], np.zeros(len(nhat))], 1)
    phihat /= np.linalg.norm(phihat, axis=1, keepdims=True)
    thetahat = np.cross(phihat, nhat)
    thetahat /= np.linalg.norm(thetahat, axis=1, keepdims=True)
    avec = alpha[:, :1] * thetahat + alpha[:, 1:2] * phihat
    tomass = mass_vec[None, :] - nhat * (nhat @ mass_vec)[:, None]
    tomass /= np.linalg.norm(tomass, axis=1, keepdims=True)
    cosang = np.sum(avec[sel] * tomass[sel], axis=1) \
        / np.linalg.norm(avec[sel], axis=1)
    assert np.median(cosang) > 0.999


def test_pointmass_shear_positions_radius_through_port(port_pointmass):
    cfg, rt, mass_vec, mass_plane, alpha, gamma_lens = port_pointmass
    pp = tdriver.plane_params(cfg, rt.cosmo, mass_plane)
    q = pm.charge(cfg, rt.cosmo, pp.rad)
    A = np.array(rt.rays.A)
    kappa = 1.0 - 0.5 * (A[:, 0, 0] + A[:, 1, 1])
    g1 = 0.5 * (A[:, 1, 1] - A[:, 0, 0])
    g2 = -0.5 * (A[:, 0, 1] + A[:, 1, 0])
    shear = np.sqrt(g1**2 + g2**2)
    sel = (gamma_lens > 0.15) & (gamma_lens < 0.4)
    ref = pm.shear_tangential(gamma_lens[sel], q, pp.rad, cfg.maxComvDistance)
    assert np.median(np.abs(shear[sel] - ref) / ref) < 0.05
    assert np.median(np.abs(kappa[sel])) < 0.05 * np.median(ref)
    ws = cfg.maxComvDistance
    n = np.array(rt.rays.n)
    nhat = n / np.linalg.norm(n, axis=1, keepdims=True)
    gamma_final = np.arccos(np.clip(nhat @ mass_vec, -1, 1))
    vec0 = hp.pix2vec_nest(rt.ray_nest, cfg.rayOrder)
    gamma0 = np.arccos(np.clip(vec0 @ mass_vec, -1, 1))
    sel = (gamma0 > 0.1) & (gamma0 < 0.4)
    pred = gamma0[sel] - (ws - pp.rad) / ws * pm.alpha_exact(gamma0[sel], q)
    err = np.abs(gamma_final[sel] - pred) / pm.alpha_exact(gamma0[sel], q)
    assert np.median(err) < 0.05, np.median(err)
    r = np.linalg.norm(n, axis=1)
    assert np.allclose(r, cfg.maxComvDistance, rtol=1e-10)


def test_cli_runs_and_resumes(tmp_path):
    """python -m calclens_tpu_torch.raytrace <cfg> [restart_plane] on the
    CPU: a tiny point-mass trace writes restart.npz and timing.0, and a
    second call resumes from the restart at the given plane."""
    planes = tmp_path / "planes"
    out = tmp_path / "out"
    cfg = RayTraceConfig(
        OmegaM=0.3, maxComvDistance=800.0, NumLensPlanes=3,
        LensPlanePath=str(planes), LensPlaneName="pm", SHTOrder=3,
        rayOrder=3, bundleOrder=1, partMass=1.0e15, raPointMass=40.0,
        decPointMass=10.0, radPointMass=400.0, PointMassTest=True,
        OutputPath=str(out)).finalize()
    pm.make_pointmass_planes(cfg)
    path = tmp_path / "raytrace.cfg"
    path.write_text(cfg.to_cfg())
    assert port_main([str(path), "--device", "cpu"]) == 0
    with np.load(out / "restart.npz") as z:
        assert int(z["current_plane"]) == 3
        first = z["n"].copy()
    rows = (out / "timing.0").read_text().splitlines()
    assert rows[0].startswith("#") and len(rows) == 4
    assert port_main([str(path), "2", "--device", "cpu"]) == 0
    with np.load(out / "restart.npz") as z:
        assert int(z["current_plane"]) == 3
        # one more plane propagated from the end state: rays moved on
        assert np.all(np.isfinite(z["n"])) and not np.array_equal(z["n"],
                                                                  first)
    assert os.path.exists(str(out / "restart.npz.bak"))
