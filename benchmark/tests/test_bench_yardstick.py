"""The yardstick on the CPU: the Legendre work counts against a brute-force
count, the trace reader on a made-up trace, the reference's HEALPix
geometry and band-limited kernel, and the reference's plane step against
the program's float64 step (to rounding)."""

import math

import numpy as np
import pytest
import torch

from bench_tiny import REPO  # noqa: F401  (puts the repository on sys.path)

from benchmark import reference as R
from benchmark import roofline
from benchmark.tracing import Trace


@pytest.mark.parametrize("order,mg", [(1, None), (2, None), (3, None),
                                      (3, 2.0), (4, 5.0), (4, 0.5)])
def test_legendre_work_counts(order, mg):
    assert roofline.elements(order, mg=mg) == roofline.elements_brute(
        order, mg=mg)


def test_least_seconds_positive():
    import json
    import os

    for spec, fn in (("legendre_analysis", "analysis"),
                     ("legendre_synth", "synthesis"),
                     ("legendre_synth", "synthesis_phi")):
        with open(os.path.join(REPO, "benchmark", "kernels",
                               spec + ".json")) as fp:
            s, bound = roofline.least_seconds(json.load(fp), fn, 12)
        assert s > 0 and bound in ("recurrence", "contraction", "bytes")


def test_trace_reader():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench_window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void legendre_synth_kernel<16>",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 25,
         "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::unique_consecutive",
         "ts": 38, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 5},
    ]
    t = Trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)        # [10, 40] and [70, 80]
    assert t.kernel_seconds(["legendre_synth_kernel"]) == (
        pytest.approx(20e-6), 1)
    gaps = t.idle_gaps()
    assert gaps[0][0] == "aten::unique_consecutive"
    assert gaps[0][1] == pytest.approx(30e-6)      # 40 .. 70
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])


@pytest.mark.parametrize("order", [2, 3, 5])
def test_healpix_against_the_program(order):
    from calclens_tpu_torch.healpix import core as hp

    H = R.Healpix(order, "cpu")
    pix = torch.arange(H.npix)
    np.testing.assert_allclose(H.pix2vec(pix).numpy(),
                               hp.pix2vec_ring(pix.numpy(), order), atol=1e-14)
    rng = np.random.default_rng(order)
    v = rng.normal(size=(5000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    th, ph = np.arccos(v[:, 2]), np.mod(np.arctan2(v[:, 1], v[:, 0]), 2 * np.pi)
    got = H.ang2pix(torch.tensor(th), torch.tensor(ph)).numpy()
    np.testing.assert_array_equal(got, hp.ang2pix_ring(th, ph, order))
    np.testing.assert_array_equal(H.vec2pix(torch.tensor(v * 3.0)).numpy(),
                                  hp.ang2pix_ring(th, ph, order))


@pytest.mark.parametrize("order", [6, 12])
def test_float32_pixels_as_the_program_finds_them(order):
    """On float32 positions the reference's float32 pixels are the
    program's NGP pixels, to the last particle."""
    from calclens_tpu_torch.healpix import torchhp

    g = torch.Generator().manual_seed(order)
    pos = torch.randn(200000, 3, generator=g) * 50.0
    np.testing.assert_array_equal(
        R.Healpix(order, "cpu").vec2pix(pos).numpy(),
        torchhp.ang2pix_ring(*torchhp.vec2ang(pos), order).numpy())


@pytest.mark.parametrize("order,bundle,box", [
    (6, 2, (10.0, 24.709, -7.5, 7.5)), (7, 3, (200.0, 260.0, -40.0, 20.0)),
    (5, 1, (0.0, 360.0, -90.0, -60.0))])
def test_box_pixels_are_the_programs_rays(order, bundle, box):
    import types

    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer
    from calclens_tpu_torch.healpix import core as hp

    cfg = RayTraceConfig(rayOrder=order, bundleOrder=bundle, SHTOrder=4,
                         NumLensPlanes=160, maxComvDistance=4000.0,
                         minRa=box[0], maxRa=box[1], minDec=box[2],
                         maxDec=box[3]).finalize()
    nest = Raytracer.active_ray_pixels(types.SimpleNamespace(cfg=cfg))
    want = hp.nest2ring(nest, order)
    H = R.Healpix(order, "cpu")
    np.testing.assert_array_equal(H.box_pixels(box).numpy(), want)
    cols = torch.tensor([0, 7, len(want) // 2, len(want) - 1])
    pix, n = H.box_pixel_at(box, cols)
    assert n == len(want)
    np.testing.assert_array_equal(pix.numpy(), want[cols.numpy()])


def test_kernel_table_against_a_direct_sum():
    L = 60
    H = R.Healpix(4, "cpu")
    taps = H.pix2vec(torch.tensor([0, 5, 100]))
    kern, _ = R.legendre_pass(H, L, taps)
    x = torch.tensor([1.0, 0.9999, 0.99, 0.3, 0.0, -0.001, -0.7, -0.99995,
                      -1.0], dtype=torch.float64)
    P = [torch.ones_like(x), x.clone()]
    for l in range(1, L):
        P.append(((2 * l + 1) * x * P[l] - l * P[l - 1]) / (l + 1))
    want = sum(R.c_l(l) * P[l] for l in range(1, L + 1))
    got = kern(x)[0]
    assert float((got - want).abs().max() / want.abs().max()) < 1e-9


BOX = (10.0, 24.709, -7.5, 7.5)


@pytest.mark.parametrize("sht_order,ray_order,box", [
    (4, 3, None), (4, 4, None), (4, 6, BOX)])
def test_reference_plane_equals_the_programs_float64_plane(sht_order,
                                                           ray_order, box):
    """The reference's plane step against the program's float64 step, on
    the same inputs, from the same state: equal to rounding (the program's
    tabulated scale factor sets ~1e-10).  On a box, the map is live 5
    degrees around it."""
    from calclens_tpu_torch.config import RayTraceConfig
    from calclens_tpu_torch.driver import Raytracer

    sky = {} if box is None else dict(zip(("minRa", "maxRa", "minDec",
                                           "maxDec"), box))
    cfg = RayTraceConfig(OmegaM=0.286, maxComvDistance=4000.0,
                         NumLensPlanes=160, SHTOrder=sht_order,
                         rayOrder=ray_order, bundleOrder=2, Precision="f64",
                         SHTOnly=True, **sky).finalize()
    rt = Raytracer(cfg, device="cpu")
    rt.init_rays()
    n = rt.rays_packed.shape[1]
    binL = 25.0
    Hr = R.Healpix(ray_order, "cpu")
    cols = torch.arange(n)
    pix = cols if box is None else Hr.box_pixel_at(box, cols)[0]
    live = None if box is None else (box[0] - 5.0, box[1] + 5.0,
                                     box[2] - 5.0, box[3] + 5.0)
    start = R.initial_state(Hr, pix, binL / 2)
    assert float((start - rt.rays_packed).abs().max()) < 1e-12
    g = torch.Generator().manual_seed(3)
    v = torch.randn(3000, 3, generator=g, dtype=torch.float64)
    pos = v / v.norm(dim=1, keepdim=True) * 60.0
    mass = torch.full((3000,), 3e12, dtype=torch.float64)
    H = R.Healpix(sht_order, "cpu")
    L = 3 * (1 << sht_order) - 1
    for plane in (0, 1):
        pre = rt.rays_packed.clone()
        rt.step(plane, pos=pos, mass=mass)
        scal = R.plane_scalars(plane, 160, 4000.0, 0.286)
        ref = R.plane_step(H, L, pre, pos, mass, scal, live)
        for rows in (slice(0, 14), slice(14, 16), slice(16, 20), slice(20, 21)):
            d = (ref[rows] - rt.rays_packed[rows]).abs().max()
            assert float(d / ref[rows].abs().max()) < 1e-8, rows
