"""The port's lens maps (calclens_tpu_torch.maps, the NEST <-> RING device
helpers of healpix/torchhp.py, the FITS writer and the driver's map loop)
against the JAX package on the same inputs, on the CPU.

Tolerances: integer outputs (pixel ids, counts) and written files exactly;
per-pixel sums in float64 within 1e-12 of each row's max (the port and JAX
sum the 4^k children of a map pixel in other orders); maps written by a
whole trace within 1e-9 (two FFT libraries in the SHT solve, as in
tests/test_torch_raytrace.py)."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu import maps as jmaps
from calclens_tpu.config import RayTraceConfig
from calclens_tpu.driver import Raytracer as JRaytracer
from calclens_tpu.healpix import core as hp
from calclens_tpu.healpix import jaxhp
from calclens_tpu.io import fits as jfits
from calclens_tpu.testing import pointmass as pm
from calclens_tpu_torch import maps as tmaps
from calclens_tpu_torch.driver import Raytracer as TRaytracer
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.io import fits as tfits
from calclens_tpu_torch.raytrace import main as port_main


@pytest.mark.parametrize("order", [0, 1, 3, 6, 10, 13])
def test_nest_ring_device_helpers_match_jax(order):
    rng = np.random.default_rng(order)
    npix = int(hp.order2npix(order))
    pix = rng.integers(0, npix, size=min(npix, 4096)).astype(np.int64)
    pix[0], pix[-1] = 0, npix - 1
    tp, jp = torch.tensor(pix), jnp.asarray(pix, jnp.int32)
    for got, ref in zip(torchhp.ring2xyf_dev(tp, order),
                        jaxhp.ring2xyf_dev(jp, order)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    nest = torchhp.ring2nest_dev(tp, order)
    np.testing.assert_array_equal(nest.numpy(),
                                  np.asarray(jaxhp.ring2nest_dev(jp, order)))
    np.testing.assert_array_equal(nest.numpy(), hp.ring2nest(pix, order))
    back = torchhp.nest2ring_dev(nest, order)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jaxhp.nest2ring_dev(jnp.asarray(nest.numpy()), order)))
    np.testing.assert_array_equal(back.numpy(), pix)
    x, y, f = (jnp.asarray(np.asarray(v)) for v in jaxhp.ring2xyf_dev(jp, order))
    np.testing.assert_array_equal(
        torchhp.xyf2ring_dev(*(torch.tensor(np.asarray(v)) for v in (x, y, f)),
                             order).numpy(),
        np.asarray(jaxhp.xyf2ring_dev(x, y, f, order)))
    for mo in sorted({0, order // 2, order}):
        np.testing.assert_array_equal(
            torchhp.coarse_nest_from_ring(tp, order, mo).numpy(),
            np.asarray(jaxhp.coarse_nest_from_ring(jp, order, mo)))


def _stepped_jax_raytracer():
    """A JAX Raytracer after one plane at SHTOrder 5 / rayOrder 5, f64
    (tests/test_lensmap_device.py's state)."""
    cfg = RayTraceConfig(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        SHTOrder=5, rayOrder=5, bundleOrder=2, Precision="f64",
    ).finalize()
    rt = JRaytracer(cfg)
    rt.init_rays()
    rng = np.random.default_rng(11)
    v = rng.normal(size=(4096, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rt.step(1, pos=v * 375.0, mass=np.full(4096, 5.0e15))
    return rt


@pytest.fixture(scope="module")
def stepped():
    jrt = _stepped_jax_raytracer()
    trt = TRaytracer(jrt.cfg, device="cpu")
    trt.load_state(np.asarray(jrt.rays_packed), jrt.current_plane)
    return jrt, trt


def _assert_sums_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(got[0], ref[0])  # counts: exact
    for k in range(1, 7):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-12 * np.abs(ref[k]).max(),
                                   err_msg=str(k))


@pytest.mark.parametrize("map_order", [3, 5])
def test_accum_fullsky_matches_jax(stepped, map_order):
    jrt, trt = stepped
    ray_order = jrt.cfg.rayOrder
    ref = np.asarray(jmaps.accum_lens_map_packed(jrt.rays_packed, None,
                                                 ray_order, map_order))
    got = tmaps.accum_lens_map_packed(trt.rays_packed, None, ray_order,
                                      map_order)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    _assert_sums_close(got.numpy(), ref)
    # the scatter path (rays given by their nest index) gives the same sums
    nest = hp.ring2nest(np.arange(trt.rays_packed.shape[1]), ray_order)
    _assert_sums_close(tmaps.accum_lens_map_packed(
        trt.rays_packed, nest, ray_order, map_order).numpy(), ref)
    a = tmaps.LensMapAccum.from_stacked(got)
    b = jmaps.LensMapAccum.from_stacked(jnp.asarray(ref))
    np.testing.assert_array_equal(a.count, np.asarray(b.count))
    np.testing.assert_allclose(tmaps.convergence_from_accum(a),
                               jmaps.convergence_from_accum(b), rtol=0,
                               atol=1e-7)


def test_map_order_above_ray_order_raises(stepped):
    _, trt = stepped
    with pytest.raises(ValueError, match="above rayOrder"):
        tmaps.accum_lens_map_packed(trt.rays_packed, None, 5, 6)
    trt.cfg.LensMapOrder = 6
    try:
        with pytest.raises(ValueError, match="cannot be finer"):
            trt._write_map_outputs()
    finally:
        trt.cfg.LensMapOrder = -1


def test_write_map_outputs_byte_identical(tmp_path):
    """The same LensMapAccum written by both packages: the same bytes."""
    rng = np.random.default_rng(2)
    npix = int(hp.order2npix(3))
    cnt = rng.integers(0, 5, size=npix).astype(np.int32)
    rows = [rng.normal(size=npix) * cnt for _ in range(6)]
    ta = tmaps.LensMapAccum(cnt, *rows)
    ja = jmaps.LensMapAccum(cnt, *rows)
    got = tmaps.write_map_outputs(ta, 3, str(tmp_path / "port"), 4)
    ref = jmaps.write_map_outputs(ja, 3, str(tmp_path / "jax"), 4)
    for g, r in zip(got, ref):
        assert os.path.basename(g) == os.path.basename(r)
        with open(g, "rb") as a, open(r, "rb") as b:
            assert a.read() == b.read(), g
    hdr, rec = tfits.read_fits(got[1])[1]
    assert hdr["NSIDE"] == 8 and hdr["ORDERING"] == "NESTED"
    np.testing.assert_array_equal(rec["N_RAYS"], cnt)
    cards = [tfits.image_hdu(np.arange(6, dtype=np.float64).reshape(2, 3),
                             header={"LONGKEYWORD": (1.5, "hierarch")},
                             primary=True)]
    assert cards[0][0] == jfits.image_hdu(
        np.arange(6, dtype=np.float64).reshape(2, 3),
        header={"LONGKEYWORD": (1.5, "hierarch")})[0]


def test_map_plane_nums_match_jax(tmp_path):
    z = np.array([0.0, 0.05, 0.1, 0.3, 0.7, 1.2, 2.5])
    for om in (0.25, 0.3):
        np.testing.assert_array_equal(
            tmaps.comoving_distance_2f1(z, om),
            jmaps.comoving_distance_2f1(z, om))
        np.testing.assert_array_equal(
            tmaps.map_plane_nums(z, om, 3000.0, 60),
            jmaps.map_plane_nums(z, om, 3000.0, 60))
    path = tmp_path / "zs.txt"
    path.write_text("0.1\n\n0.25\n 0.5 \n")
    np.testing.assert_array_equal(tmaps.read_map_redshifts(str(path)),
                                  jmaps.read_map_redshifts(str(path)))


def test_trace_with_lens_maps_matches_jax(tmp_path):
    """A 3-plane point-mass trace with MapRedshiftList through both
    packages (the port through python -m calclens_tpu_torch.raytrace):
    the same Convergence_ and Rays_ files, within 1e-9 (f64)."""
    zs = tmp_path / "zs.txt"
    zs.write_text("0.1\n0.2\n")
    base = dict(OmegaM=0.3, maxComvDistance=800.0, NumLensPlanes=3,
                LensPlanePath=str(tmp_path / "planes"), LensPlaneName="pm",
                SHTOrder=4, rayOrder=4, bundleOrder=1, partMass=1.0e15,
                raPointMass=40.0, decPointMass=10.0, radPointMass=400.0,
                PointMassTest=True, Precision="f64",
                MapRedshiftList=str(zs), LensMapOrder=2)
    jcfg = RayTraceConfig(OutputPath=str(tmp_path / "jax"), **base).finalize()
    pm.make_pointmass_planes(jcfg)
    jrt = JRaytracer(jcfg)
    jrt.init_rays()
    # the JAX driver seeds even an f64 trace from float32 pixel centres
    # (test_port_init_rays_are_float64_pixel_centres): start it from the
    # port's float64 state, so both traces follow the same rays
    trt = TRaytracer(jcfg, device="cpu")
    trt.init_rays()
    jrt.rays_packed = jnp.asarray(trt.rays_packed.numpy())
    jrt.run(progress=False)
    pcfg = RayTraceConfig(OutputPath=str(tmp_path / "port"),
                          **base).finalize()
    path = tmp_path / "raytrace.cfg"
    path.write_text(pcfg.to_cfg())
    assert port_main([str(path), "--device", "cpu"]) == 0
    nums = jmaps.map_plane_nums([0.1, 0.2], 0.3, 800.0, 3)
    assert list(nums) == [1, 2]
    for i in range(2):
        name = f"Convergence_4_{i}.fits"
        (_, g), (_, r) = (tfits.read_fits(str(tmp_path / d / name))[1]
                          for d in ("port", "jax"))
        np.testing.assert_allclose(g["SIGNAL"], r["SIGNAL"], rtol=0,
                                   atol=1e-9 + 1e-9 * np.abs(r["SIGNAL"]).max())
        name = f"Rays_4_{i}.fits"
        (_, g), (_, r) = (tfits.read_fits(str(tmp_path / d / name))[1]
                          for d in ("port", "jax"))
        assert g.dtype.names == r.dtype.names
        np.testing.assert_array_equal(g["N_RAYS"], r["N_RAYS"])
        np.testing.assert_array_equal(g["NEST_IDX"], r["NEST_IDX"])
        for k in ("A00", "A01", "A10", "A11", "ra", "dec"):
            np.testing.assert_allclose(
                g[k], r[k], rtol=0, atol=1e-9 * max(np.abs(r[k]).max(), 1.0),
                err_msg=f"{name} {k}")
    # the convergence is not trivially zero: the point mass lensed the rays
    sig = tfits.read_fits(str(tmp_path / "port" / "Convergence_4_1.fits")
                          )[1][1]["SIGNAL"]
    assert np.abs(sig).max() > 0


def test_port_init_rays_are_float64_pixel_centres():
    """An f64 port trace starts from float64 pixel centres.  The JAX
    driver's full-sky init_rays calls rays/soa.init_packed_fullsky without
    its dtype, so an f64 JAX trace starts from float32 centres (1e-6 of the
    radius off); the port does not copy that."""
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=800.0, NumLensPlanes=3,
                         SHTOrder=4, rayOrder=4, bundleOrder=1,
                         Precision="f64").finalize()
    trt = TRaytracer(cfg, device="cpu")
    trt.init_rays()
    wp = 800.0 / 3 / 2
    v = hp.pix2vec_ring(np.arange(int(hp.order2npix(4))), 4).T
    got = trt.rays_packed.numpy()
    np.testing.assert_allclose(got[0:3], v * wp, rtol=0, atol=1e-14 * wp)
    np.testing.assert_allclose(got[3:6], v, rtol=0, atol=1e-15)
    jrt = JRaytracer(cfg)
    jrt.init_rays()
    off = np.abs(np.asarray(jrt.rays_packed)[0:3] - v * wp).max() / wp
    assert off > 1e-9, off  # float32 centres on the JAX side


def test_float32_dec_at_the_poles_no_worse_than_jax():
    """A JAX-side difference (ROADMAP Queue 3): the JAX lens map takes a
    ray's colatitude as arccos(z / r), which in float32 is off by
    eps / sin(theta) next to the poles; the port takes atan2(rho, z).  On
    float32 rays of the rayOrder-10 pixels nearest both poles, the port's
    order-8 dec sums lie within 1e-6 of float64's (of the row's max) and
    no farther than JAX's."""
    order, map_order = 10, 8
    npix = 12 * 4**order
    ring = np.concatenate([np.arange(4 * 200), npix - 1 - np.arange(4 * 200)])
    nest = hp.ring2nest(ring, order)
    v = hp.pix2vec_ring(ring, order) * 1234.5
    packed = np.zeros((21, len(ring)), np.float32)
    packed[0:3] = v.T
    packed[6] = packed[9] = 1.0
    p64 = packed.astype(np.float64)
    lpix = nest >> (2 * (order - map_order))
    dec64 = 90.0 - np.degrees(np.arctan2(np.hypot(p64[0], p64[1]), p64[2]))
    ref = np.bincount(lpix, weights=dec64, minlength=12 * 4**map_order)
    got = tmaps.accum_lens_map_packed(torch.tensor(packed), nest, order,
                                      map_order)[6].double().numpy()
    jax_ = np.asarray(jmaps.accum_lens_map_packed(
        jnp.asarray(packed), nest, order, map_order))[6].astype(np.float64)
    scale = np.abs(ref).max()
    port_err = np.abs(got - ref).max() / scale
    jax_err = np.abs(jax_ - ref).max() / scale
    assert port_err < 1e-6, port_err
    assert port_err <= jax_err, (port_err, jax_err)
