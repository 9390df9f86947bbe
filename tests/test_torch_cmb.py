"""The port's CMB mode and legacy restarts (calclens_tpu_torch/io/
legacy_restart.py, Raytracer.load_legacy_restart / propagate_to_cmb,
raytrace.run_cmb_mode and the CLI) against calclens_tpu on the same numpy
inputs, on the CPU, float64.

The ray state is synthetic: every rayOrder-4 pixel (or a box's) with its
direction moved by 1e-2, at the radius of the plane the state stands
before, A and Aprev perturbed by 1e-2.

Tolerances: the legacy files written from one state byte for byte; rays
and lens-map sums 1e-12 of each quantity's max (the packages sum a map
pixel's rays in other orders, and round the propagation alike only to
1e-16); the CMB radii chi(z = 1100) within 1e-12."""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from calclens_tpu.config import RayTraceConfig
from calclens_tpu.driver import Raytracer as JRaytracer
from calclens_tpu.healpix import core as hp
from calclens_tpu.io import legacy_restart as jlr
from calclens_tpu.raytrace import main as jax_main
from calclens_tpu.testing import pointmass as pm
from calclens_tpu_torch import maps as tmaps
from calclens_tpu_torch.driver import Raytracer as TRaytracer
from calclens_tpu_torch.gals import gridsearch as tgs
from calclens_tpu_torch.gals import io as tgio
from calclens_tpu_torch.io import fits as tfits
from calclens_tpu_torch.io import legacy_restart as tlr
from calclens_tpu_torch.raytrace import main as port_main
from calclens_tpu_torch.raytrace import run_cmb_mode

GROUPS = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))
BOX = dict(minRa=20.0, maxRa=120.0, minDec=-30.0, maxDec=40.0)


def _cfg(tmp, **kw):
    base = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                SHTOrder=4, rayOrder=4, bundleOrder=2, Precision="f64",
                OutputPath=str(tmp), LensMapOrder=3)
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _state(cfg, nest, plane, seed=1):
    """Packed f64 rays at the given NEST pixels before plane `plane`."""
    rng = np.random.default_rng(seed)
    vec = hp.pix2vec_nest(nest, cfg.rayOrder).T
    n = vec + 1e-2 * rng.normal(size=vec.shape)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    packed = 1e-3 * rng.normal(size=(21, len(nest)))
    packed[0:3] = n * (plane * binL + binL / 2.0)
    packed[3:6] = vec + 1e-3 * rng.normal(size=vec.shape)
    for r in (6, 9, 10, 13):
        packed[r] += 1.0
    packed[6:14] += 1e-2 * rng.normal(size=(8, len(nest)))
    return packed


def _row_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return max(float(np.abs(got[a:b] - ref[a:b]).max()
                     / (np.abs(ref[a:b]).max() + 1e-300)) for a, b in GROUPS)


def _full_sky_rays(cfg, plane):
    """(packed in RING order, its NEST pixels) of the full sky."""
    npix = int(hp.order2npix(cfg.rayOrder))
    nest = hp.ring2nest(np.arange(npix), cfg.rayOrder)
    return _state(cfg, nest, plane), nest


def test_legacy_restart_files_match_jax(tmp_path):
    """The port's copy writes JAX's bytes and reads them as JAX does."""
    cfg = _cfg(tmp_path)
    packed, nest = _full_sky_rays(cfg, 5)
    for m, d in ((tlr, "t"), (jlr, "j")):
        (tmp_path / d).mkdir()
        m.write_legacy_restart(str(tmp_path / d), cfg, packed, nest,
                               current_plane=5, map_num=2)
    got = (tmp_path / "t" / "restart.0").read_bytes()
    assert got == (tmp_path / "j" / "restart.0").read_bytes()
    meta, _, rays, cells = tlr.read_legacy_restart_file(
        str(tmp_path / "j" / "restart.0"))
    jmeta, _, jrays, jcells = jlr.read_legacy_restart_file(
        str(tmp_path / "j" / "restart.0"))
    assert rays.tobytes() == jrays.tobytes()
    np.testing.assert_array_equal(cells, jcells)
    assert (meta["CurrentPlaneNum"], meta["CurrentMapNum"]) == (5, 2)
    for f in ("rayOrder", "bundleOrder", "OmegaM", "NumLensPlanes"):
        assert meta[f] == jmeta[f]
    for g, r in zip(tlr.legacy_rays_to_packed(meta, rays, np.float64),
                    jlr.legacy_rays_to_packed(jmeta, jrays, np.float64)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("sky", ["full", "box"])
def test_load_legacy_restart_round_trip(tmp_path, sky):
    """A state written as a legacy restart and loaded by a new Raytracer:
    the same rays in RING order of their pixels, _ray_nest set, the plane
    counters restored; JAX's loader holds the same rays in NEST order.  The
    file holds whole bundle cells (the reference's layout), so a box's file
    holds every ray of the bundle cells whose centres lie in the box."""
    kw = BOX if sky == "box" else {}
    cfg = _cfg(tmp_path, **kw)
    nest = np.arange(int(hp.order2npix(cfg.rayOrder)))
    if sky == "box":
        ra, dec = hp.ang2radec(*hp.pix2ang_nest(
            nest >> 2 * (cfg.rayOrder - cfg.bundleOrder), cfg.bundleOrder))
        nest = nest[(ra >= BOX["minRa"]) & (ra <= BOX["maxRa"])
                    & (dec >= BOX["minDec"]) & (dec <= BOX["maxDec"])]
    nest = nest[np.argsort(hp.nest2ring(nest, cfg.rayOrder))]
    packed = _state(cfg, nest, 3)
    tlr.write_legacy_restart(str(tmp_path), cfg, packed, nest,
                             current_plane=3, map_num=1)
    rt = TRaytracer(cfg, device="cpu")
    rt.load_legacy_restart()
    np.testing.assert_array_equal(rt.rays_packed.numpy(), packed)
    np.testing.assert_array_equal(rt._ray_nest, nest)
    assert (rt.current_plane, rt.map_num) == (3, 1)
    jrt = JRaytracer(cfg)
    jrt.load_legacy_restart(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jrt.rays_packed),
                                  packed[:, np.argsort(nest)])


@pytest.mark.parametrize("field,value", [("OmegaM", 0.25),
                                         ("NumLensPlanes", 9),
                                         ("maxDec", 80.0)])
def test_load_legacy_restart_raises_on_a_mismatched_field(tmp_path, field,
                                                          value):
    cfg = _cfg(tmp_path)
    packed, nest = _full_sky_rays(cfg, 2)
    tlr.write_legacy_restart(str(tmp_path), cfg, packed, nest, 2)
    rt = TRaytracer(_cfg(tmp_path, **{field: value}), device="cpu")
    with pytest.raises(ValueError, match=field):
        rt.load_legacy_restart()
    assert rt.rays_packed is None


def test_propagate_to_cmb_matches_jax(tmp_path):
    """One state through both packages' propagate_to_cmb (map order 3):
    the same rays, at chi(1100), and the same lens-map sums."""
    cfg = _cfg(tmp_path)
    packed, _ = _full_sky_rays(cfg, 8)
    jrt = JRaytracer(cfg)
    jrt.rays_packed = jnp.asarray(packed)
    jrt.current_plane = 8
    ref = jrt.propagate_to_cmb(map_order=3)
    trt = TRaytracer(cfg, device="cpu")
    trt.load_state(packed, 8)
    got = trt.propagate_to_cmb(map_order=3)
    assert _row_err(trt.rays_packed.numpy(), np.asarray(jrt.rays_packed)) \
        < 1e-12
    w_cmb = float(tmaps.comoving_distance_2f1(1100.0, cfg.OmegaM))
    np.testing.assert_allclose(
        np.linalg.norm(trt.rays_packed.numpy()[0:3], axis=0), w_cmb,
        rtol=1e-12)
    np.testing.assert_array_equal(got.count, np.asarray(ref.count))
    assert int(got.count.sum()) == packed.shape[1]
    for k in ("A00", "A01", "A10", "A11", "ra", "dec"):
        r = np.asarray(getattr(ref, k))
        np.testing.assert_allclose(getattr(got, k), r, rtol=0,
                                   atol=1e-12 * np.abs(r).max(), err_msg=k)


def test_cmb_mode_through_the_cli_matches_jax(tmp_path):
    """python -m ...raytrace with CMBLensing on a legacy restart.0, through
    both packages' CLIs (the port's with --device cpu): the three files'
    values within 1e-12 (of the larger of 1 and the column's max)."""
    files = ("restart_rays_at_cmb.0", "CMB_convergence_8.fits",
             "CMB_rays_8.fits")
    base = _cfg(tmp_path)
    packed, nest = _full_sky_rays(base, 6)
    for d, run in (("jax", lambda p: jax_main([p])),
                   ("port", lambda p: port_main([p, "--device", "cpu"]))):
        cfg = _cfg(tmp_path / d, CMBLensing=1, CMBMapOrder=3)
        os.makedirs(cfg.OutputPath)
        tlr.write_legacy_restart(cfg.OutputPath, cfg, packed, nest,
                                 current_plane=6)
        path = tmp_path / f"{d}.cfg"
        path.write_text(cfg.to_cfg())
        assert run(str(path)) == 0
        assert set(files) <= set(os.listdir(cfg.OutputPath))
    t, j = tmp_path / "port", tmp_path / "jax"
    (meta, _, rays, _), (jmeta, _, jrays, _) = (
        tlr.read_legacy_restart_file(str(d / files[0])) for d in (t, j))
    assert meta["CurrentPlaneNum"] == jmeta["CurrentPlaneNum"] == 6
    np.testing.assert_array_equal(rays["nest"], jrays["nest"])
    for c in ("n", "beta", "alpha", "A", "Aprev", "U", "phi"):
        np.testing.assert_allclose(rays[c], jrays[c], rtol=0, atol=1e-12
                                   * max(1.0, np.abs(jrays[c]).max()))
    for name, cols in ((files[1], ("SIGNAL",)),
                       (files[2], ("N_RAYS", "NEST_IDX", "A00", "A01", "A10",
                                   "A11", "ra", "dec"))):
        (_, g), (_, r) = (tfits.read_fits(str(d / name))[1] for d in (t, j))
        for c in cols:
            np.testing.assert_allclose(
                g[c], r[c], rtol=0,
                atol=1e-12 * max(1.0, float(np.abs(r[c]).max())),
                err_msg=f"{name} {c}")
    rec = tfits.read_fits(str(t / files[2]))[1][1]
    assert int(rec["N_RAYS"].sum()) == packed.shape[1]


def test_cmb_map_order_above_ray_order_raises_before_any_work(tmp_path):
    cfg = _cfg(tmp_path / "out", CMBLensing=1, CMBMapOrder=5)
    packed, _ = _full_sky_rays(cfg, 8)
    rt = TRaytracer(cfg, device="cpu")
    rt.load_state(packed, 8)
    for call in (lambda: run_cmb_mode(rt),
                 lambda: rt.propagate_to_cmb(map_order=5)):
        with pytest.raises(ValueError, match="above rayOrder"):
            call()
    np.testing.assert_array_equal(rt.rays_packed.numpy(), packed)
    assert not os.path.exists(cfg.OutputPath)


def test_run_after_a_legacy_restart_takes_the_cut_sky_paths(tmp_path,
                                                            monkeypatch):
    """A full-sky state resumed from a legacy restart carries _ray_nest, so
    run() takes the cut-sky galaxy search (ring_rows) and the lens maps'
    scatter path; its catalogs and maps equal those of the same state
    resumed by load_state.  The JAX driver keeps the legacy rays in NEST
    order, so its cut-sky search refuses them (the ring rows do not
    increase)."""
    rng = np.random.default_rng(4)
    g = rng.normal(size=(120, 3))
    g *= rng.uniform(800.0, 1900.0, (120, 1)) / np.linalg.norm(
        g, axis=1, keepdims=True)
    tgio.write_source_gals(str(tmp_path / "cat.fit"), g)
    (tmp_path / "gals.txt").write_text(str(tmp_path / "cat.fit") + "\n")
    zs = tmp_path / "zs.txt"
    zs.write_text("0.6\n")

    def cfg_at(out):
        return _cfg(out, SHTOrder=5, LensPlanePath=str(tmp_path),
                    LensPlaneName="pm", partMass=5.0e16, raPointMass=32.0,
                    decPointMass=14.0, radPointMass=1125.0,
                    PointMassTest=True, GalsFileList=str(tmp_path / "gals.txt"),
                    GalOutputName="gal_", MapRedshiftList=str(zs))

    pm.make_pointmass_planes(cfg_at(tmp_path / "x"), snap_to_pixel_order=5)
    packed, nest = _full_sky_rays(cfg_at(tmp_path), 3)
    seen = []
    orig = tgs.find_images_device_async

    def spy(*a, **k):
        seen.append(k.get("ring_rows"))
        return orig(*a, **k)

    monkeypatch.setattr(tgs, "find_images_device_async", spy)
    a = TRaytracer(cfg_at(tmp_path / "a"), device="cpu")
    a.load_state(packed, 3)
    a.run(progress=False)
    assert seen and all(r is None for r in seen)
    os.makedirs(tmp_path / "b")
    tlr.write_legacy_restart(str(tmp_path / "b"), a.cfg, packed, nest, 3)
    seen.clear()
    b = TRaytracer(cfg_at(tmp_path / "b"), device="cpu")
    b.load_legacy_restart()
    b.run(progress=False)
    assert seen and all(np.array_equal(r, np.arange(len(nest)))
                        for r in seen)
    names = sorted(f for f in os.listdir(tmp_path / "a")
                   if f.startswith(("gal_", "Rays_", "Convergence_")))
    assert len(names) >= 5
    for f in names:
        (_, x), (_, y) = (tfits.read_fits(str(tmp_path / d / f))[1]
                          for d in ("a", "b"))
        assert x.dtype == y.dtype and len(x) == len(y) > 0, f
        for c in x.dtype.names:
            np.testing.assert_allclose(x[c], y[c], rtol=0, atol=1e-12 * max(
                1.0, float(np.abs(y[c]).max())), err_msg=f"{f} {c}")
    jrt = JRaytracer(b.cfg)
    jrt.load_legacy_restart(str(tmp_path / "b"))
    with pytest.raises(AssertionError):
        jrt.run(progress=False)
