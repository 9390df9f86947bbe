"""The port's ray outputs (calclens_tpu_torch/rays/frames.py,
rays/soa.output_rows_obs_radec, io/rayio.py) and DebugIO field maps
against the JAX package's on the same numpy inputs, float64 on the CPU.

Tolerances: frames and the observer-frame columns agree with JAX to 1e-12
(the same formulas; float64 rounding of a few operations); the files'
headers, counts, starts and NEST columns are equal, their float columns
agree to 1e-12; each package's reader reads the other's files, and
libcfitsio parses the port's files (tests/test_fits_golden.py's bridge)."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.config import RayTraceConfig
from calclens_tpu.healpix import core as hp
from calclens_tpu.io import cfitsio
from calclens_tpu.io import rayio as jrayio
from calclens_tpu.rays import frames as jframes
from calclens_tpu.rays import soa as jsoa
from calclens_tpu.rays.propagate import Rays as JRays
from calclens_tpu_torch import maps as tmaps
from calclens_tpu_torch.io import rayio as trayio
from calclens_tpu_torch.rays import frames as tframes
from calclens_tpu_torch.rays import soa as tsoa
from calclens_tpu_torch.rays.propagate import Rays as TRays

TOL = 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread: its tensors here are small,
    and under the suite's parallel workers torch's per-process thread pools
    would oversubscribe the cores (several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(out, **kw):
    base = dict(OmegaM=0.3, maxComvDistance=1000.0, NumLensPlanes=4,
                rayOrder=4, bundleOrder=2, SHTOrder=4, OutputPath=str(out),
                RayOutputName="ray_", OutputRayDeflections=True,
                OutputPhi=True)
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _packed_rays(order, nest, seed=7):
    """[21, N] float64 rays at the given NEST pixels: positions moved off
    the pixel centres, random A, Aprev, alpha, U and phi."""
    rng = np.random.default_rng(seed)
    N = len(nest)
    vec = hp.pix2vec_nest(nest, order)
    n = vec + 0.1 * rng.normal(size=(N, 3))
    n = n / np.linalg.norm(n, axis=1, keepdims=True) * 100.0
    p = np.zeros((21, N))
    p[0:3] = n.T
    p[3:6] = vec.T
    p[6:10] = (np.eye(2).ravel()[:, None] + 0.01 * rng.normal(size=(4, N)))
    p[10:14] = (np.eye(2).ravel()[:, None]
                + 0.01 * rng.normal(size=(4, N)))
    p[14:16] = 1e-3 * rng.normal(size=(2, N))
    p[16:20] = 1e-2 * rng.normal(size=(4, N))
    p[20] = rng.normal(size=N)
    return p


def _views(p):
    def mat(i):
        return p[i: i + 4].T.reshape(-1, 2, 2)

    kw = dict(n=p[0:3].T, beta=p[3:6].T, A=mat(6), Aprev=mat(10),
              alpha=p[14:16].T, U=mat(16), phi=p[20])
    return (JRays(**{k: jnp.asarray(v) for k, v in kw.items()}),
            TRays(**{k: torch.tensor(v) for k, v in kw.items()}))


def _ring_rays(order):
    """Full-sky rays in RING storage order: (packed, nest per slot)."""
    npix = int(hp.order2npix(order))
    nest = hp.ring2nest(np.arange(npix, dtype=np.int64), order)
    return _packed_rays(order, nest), nest


def _box_rays(order):
    """A box-like subset (ra 20-140, dec -30-50) in RING order."""
    p, nest = _ring_rays(order)
    ra, dec = hp.ang2radec(*hp.pix2ang_nest(nest, order))
    keep = np.flatnonzero((ra >= 20) & (ra <= 140) & (dec >= -30)
                          & (dec <= 50))
    return p[:, keep], nest[keep]


def test_frames_roundtrip_and_match_jax():
    p, nest = _ring_rays(3)
    jr, tr = _views(p)
    obs = hp.pix2vec_nest(nest, 3)
    jo, to = jnp.asarray(obs), torch.tensor(obs)
    for jf, tf in ((jframes.rot_rays_ang2radec, tframes.rot_rays_ang2radec),
                   (jframes.rot_rays_radec2ang, tframes.rot_rays_radec2ang)):
        a, b = jf(jr), tf(tr)
        for f in ("alpha", "A", "Aprev", "U"):
            np.testing.assert_allclose(getattr(b, f).numpy(),
                                       np.asarray(getattr(a, f)), rtol=0,
                                       atol=TOL, err_msg=f)
    for jf, tf in ((jframes.paratrans_rays_curr2obs,
                    tframes.paratrans_rays_curr2obs),
                   (jframes.paratrans_rays_obs2curr,
                    tframes.paratrans_rays_obs2curr)):
        a, b = jf(jr, jo), tf(tr, to)
        for f in ("A", "Aprev"):
            np.testing.assert_allclose(getattr(b, f).numpy(),
                                       np.asarray(getattr(a, f)), rtol=0,
                                       atol=TOL, err_msg=f)
    # round trips of the port: the basis swap exactly, the transport to
    # float64 rounding
    back = tframes.rot_rays_radec2ang(tframes.rot_rays_ang2radec(tr))
    for f in ("alpha", "A", "Aprev", "U"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(tr, f).numpy())
    back = tframes.paratrans_rays_obs2curr(
        tframes.paratrans_rays_curr2obs(tr, to), to)
    for f in ("A", "Aprev"):
        np.testing.assert_allclose(getattr(back, f).numpy(),
                                   getattr(tr, f).numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("order", [2, 4])
def test_output_rows_obs_radec_matches_jax(order):
    p, nest = _ring_rays(order)
    ring = hp.nest2ring(nest, order)
    sub = np.arange(0, p.shape[1], 3)
    got = tsoa.output_rows_obs_radec(torch.tensor(p[:, sub]),
                                     torch.tensor(ring[sub]), order)
    ref = jsoa.output_rows_obs_radec(jnp.asarray(p[:, sub]),
                                     jnp.asarray(ring[sub]), order)
    assert got.shape == (tsoa.NOUT, len(sub)) and tsoa.NOUT == jsoa.NOUT
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def _read(path, fmt):
    return (trayio.read_rays_bin if fmt == "bin" else trayio.read_rays)(path)


def _assert_same_files(paths_t, paths_j, fmt):
    """Headers, counts, starts and NEST equal, float columns within TOL;
    each package's reader reads the other's file alike."""
    assert [os.path.basename(p) for p in paths_t] == \
        [os.path.basename(p) for p in paths_j]
    jread = jrayio.read_rays_bin if fmt == "bin" else jrayio.read_rays
    for pt, pj in zip(paths_t, paths_j):
        ht, nt, st, rt = _read(pt, fmt)
        hj, nj, sj, rj = jread(pj)
        assert ht == hj
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_array_equal(st, sj)
        assert rt.dtype == rj.dtype
        np.testing.assert_array_equal(rt["nest"], rj["nest"])
        for f in rt.dtype.names[1:]:
            np.testing.assert_allclose(rt[f], rj[f], rtol=0, atol=TOL,
                                       err_msg=f)
        # cross-reading: each reader on the other package's file
        for a, b in ((jread(pt), (ht, nt, st, rt)),
                     (_read(pj, fmt), (hj, nj, sj, rj))):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["host", "packed"])
@pytest.mark.parametrize("sky", ["full", "box"])
@pytest.mark.parametrize("nfiles", [1, 3])
@pytest.mark.parametrize("fmt", ["fits", "bin"])
def test_ray_files_match_jax(tmp_path, writer, sky, nfiles, fmt):
    cfg = _cfg(tmp_path / "t", NumRayOutputFiles=nfiles,
               RayOutputFormat=fmt)
    cfg_j = dataclasses.replace(cfg, OutputPath=str(tmp_path / "j"))
    p, nest = _ring_rays(cfg.rayOrder) if sky == "full" else \
        _box_rays(cfg.rayOrder)
    if writer == "host":
        jr, tr = _views(p)
        paths_t = trayio.write_rays(cfg, tr, nest, map_num=2)
        paths_j = jrayio.write_rays(cfg_j, jr, nest, map_num=2)
    else:
        slot_nest = None if sky == "full" else nest
        paths_t = trayio.write_rays_sharded(cfg, torch.tensor(p), slot_nest,
                                            map_num=2)
        paths_j = jrayio.write_rays_sharded(cfg_j, jnp.asarray(p), slot_nest,
                                            map_num=2)
    assert len(paths_t) == nfiles
    _assert_same_files(paths_t, paths_j, fmt)
    # every ray written once
    total = sum(len(_read(q, fmt)[3]) for q in paths_t)
    assert total == p.shape[1]


def test_packed_writer_chunks_alike(tmp_path, monkeypatch):
    """The packed writer's device blocks (WRITE_CHUNK rays each) give the
    files of one block."""
    cfg = _cfg(tmp_path / "a", NumRayOutputFiles=2)
    p, nest = _box_rays(cfg.rayOrder)
    pa = trayio.write_rays_sharded(cfg, torch.tensor(p), nest)
    monkeypatch.setattr(trayio, "WRITE_CHUNK", 97)
    cfg_b = dataclasses.replace(cfg, OutputPath=str(tmp_path / "b"))
    pb = trayio.write_rays_sharded(cfg_b, torch.tensor(p), nest)
    for a, b in zip(pa, pb):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.skipif(not cfitsio.available(), reason="libcfitsio not installed")
def test_port_files_parse_with_cfitsio(tmp_path):
    cfg = _cfg(tmp_path, NumRayOutputFiles=2)
    p, _ = _ring_rays(cfg.rayOrder)
    paths = trayio.write_rays_sharded(cfg, torch.tensor(p), None)
    for path in paths:
        _, num, start, rows = trayio.read_rays(path)
        with cfitsio.CFitsFile(path) as f:
            assert f.num_hdus() == 2
            f.move_to(1)
            assert f.key_long("NumFiles") == 2
            assert f.key_long("PeanoCellHEALPixOrder") == cfg.bundleOrder
            assert f.key_long("RayHEALPixOrder") == cfg.rayOrder
            layout = f.image().astype(np.int64)
            np.testing.assert_array_equal(layout, np.concatenate([num, start]))
            f.move_to(2)
            assert f.key_string("EXTNAME").strip() == "Rays"
            assert f.colnames() == list(rows.dtype.names)
            np.testing.assert_array_equal(f.column("nest", "i8"),
                                          rows["nest"])
            for c in rows.dtype.names[1:]:
                np.testing.assert_array_equal(f.column(c), rows[c])
    # DebugIO field maps (RING, one SIGNAL column each)
    order = 3
    rng = np.random.default_rng(5)
    maps6 = torch.tensor(rng.normal(size=(6, int(hp.order2npix(order)))))
    for k, path in enumerate(tmaps.write_debug_field_maps(
            maps6, order, str(tmp_path / "dbg"), 7)):
        with cfitsio.CFitsFile(path) as f:
            f.move_to(2)
            assert f.key_string("ORDERING").strip() == "RING"
            assert f.key_long("NSIDE") == 1 << order
            np.testing.assert_array_equal(
                f.column(f.colnames()[0], "f4"),
                maps6[k].numpy().astype(np.float32))


def test_debug_field_maps_match_jax(tmp_path):
    from calclens_tpu import maps as jmaps
    from calclens_tpu.io import fits as jfits

    order = 3
    rng = np.random.default_rng(6)
    maps6 = rng.normal(size=(6, int(hp.order2npix(order))))
    pt = tmaps.write_debug_field_maps(torch.tensor(maps6), order,
                                      str(tmp_path / "t"), 4)
    pj = jmaps.write_debug_field_maps([jnp.asarray(m) for m in maps6], order,
                                      str(tmp_path / "j"), 4)
    assert [os.path.basename(p) for p in pt] == \
        [os.path.basename(p) for p in pj]
    for a, b in zip(pt, pj):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert jfits.read_fits(a)[1][0]["ORDERING"] == "RING"


def test_cli_writes_ray_files_and_debug_maps(tmp_path):
    """The CLI (python -m calclens_tpu_torch.raytrace <cfg> --device cpu)
    with RayOutputName, OutputRayDeflections, OutputPhi and DebugIO writes
    the ray files at the end and six field maps per plane with particles;
    the same config
    through the JAX package's Raytracer.run writes the same files (float64:
    the maps to float32's rounding of equal values, the rays to 1e-10 of
    each column's max)."""
    from calclens_tpu.driver import Raytracer as JRaytracer
    from calclens_tpu.testing import pointmass as pm
    from calclens_tpu_torch import raytrace
    from calclens_tpu_torch.driver import Raytracer as TRaytracer

    def cfg_for(out):
        return RayTraceConfig(
            OmegaM=0.3, maxComvDistance=1000.0, NumLensPlanes=2,
            LensPlanePath=str(tmp_path), LensPlaneName="pm",
            SHTOrder=3, rayOrder=3, bundleOrder=1, partMass=1e15,
            raPointMass=40.0, decPointMass=20.0, radPointMass=250.0,
            PointMassTest=True, Precision="f64", OutputPath=str(out),
            RayOutputName="rays_", NumRayOutputFiles=2,
            OutputRayDeflections=True, OutputPhi=True, DebugIO=True,
        ).finalize()

    cfg_t, cfg_j = cfg_for(tmp_path / "t"), cfg_for(tmp_path / "j")
    pm.make_pointmass_planes(cfg_t)
    os.makedirs(cfg_t.OutputPath)
    path = tmp_path / "t" / "raytrace.cfg"
    path.write_text(cfg_t.to_cfg())
    assert raytrace.main([str(path), "--device", "cpu"]) == 0
    # the JAX full-sky init_rays starts an f64 trace from float32 pixel
    # centres (tests/test_torch_maps.py): start it from the port's state
    trt = TRaytracer(cfg_t, device="cpu")
    trt.init_rays()
    rj = JRaytracer(cfg_j)
    rj.rays_packed = jnp.asarray(trt.rays_packed.numpy())
    rj.run(progress=False)
    names = sorted(os.listdir(tmp_path / "t"))
    assert "rays_0000.0000" in names and "rays_0000.0001" in names
    # the particle-free plane 1 has no field maps
    dbg = [n for n in names if n.startswith("debug_")]
    assert dbg == sorted(f"debug_{k}_0000.fits" for k in (
        "pot", "dtheta", "dphi", "dthetatheta", "dthetaphi", "dphiphi")), \
        names
    for n in dbg:
        a = tmaps.fits.read_fits(str(tmp_path / "t" / n))[1][1]["SIGNAL"]
        b = tmaps.fits.read_fits(str(tmp_path / "j" / n))[1][1]["SIGNAL"]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.max(np.abs(b)), err_msg=n)
    for k in range(2):
        n = f"rays_0000.{k:04d}"
        ht, nt, st, rt = trayio.read_rays(str(tmp_path / "t" / n))
        hj, nj, sj, rj = jrayio.read_rays(str(tmp_path / "j" / n))
        assert ht == hj
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(rt["nest"], rj["nest"])
        for f in rt.dtype.names[1:]:
            np.testing.assert_allclose(
                rt[f], rj[f], rtol=0,
                atol=1e-10 * max(np.max(np.abs(rj[f])), 1e-300), err_msg=f)
