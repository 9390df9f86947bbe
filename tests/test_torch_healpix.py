"""Parity of the port's device HEALPix (calclens_tpu_torch.healpix.torchhp)
with calclens_tpu.healpix.jaxhp on the same numpy inputs.

Integer outputs (pixel ids, ring decode, tap ids) must be equal exactly;
float outputs agree to a few ulps of their dtype (tolerances below)."""
import subprocess
import sys
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.healpix import jaxhp
from calclens_tpu_torch.healpix import torchhp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float tolerance per dtype: a few ulps of O(1) trig results
FTOL = {np.float64: 1e-12, np.float32: 2e-6}
DTYPES = [(np.float64, torch.float64, jnp.float64),
          (np.float32, torch.float32, jnp.float32)]


def _random_vectors(n, seed, dtype):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0],
             [-1, 0, 0], [0, -1, 0], [0.6, 0, 0.8], [0, 0.6, -0.8]]
    return (v * rng.uniform(0.5, 2.0, size=(n, 1))).astype(dtype)


@pytest.mark.parametrize("order", [2, 4, 6])
@pytest.mark.parametrize("ndt,tdt,jdt", DTYPES)
def test_vec2ang_and_ang2pix_match_jaxhp(order, ndt, tdt, jdt):
    vec = _random_vectors(4000, order, ndt)
    th_j, ph_j = jaxhp.vec2ang(jnp.asarray(vec, jdt))
    th_t, ph_t = torchhp.vec2ang(torch.tensor(vec))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=0,
                               atol=FTOL[ndt])
    np.testing.assert_allclose(ph_t.numpy(), np.asarray(ph_j), rtol=0,
                               atol=4 * FTOL[ndt])
    # feed both the same angles: the pixel ids must then be identical
    th, ph = np.asarray(th_j), np.asarray(ph_j)
    pj = np.asarray(jaxhp.ang2pix_ring(jnp.asarray(th), jnp.asarray(ph),
                                       order))
    pt = torchhp.ang2pix_ring(torch.tensor(th), torch.tensor(ph), order)
    np.testing.assert_array_equal(pt.numpy(), pj)
    pv = torchhp.vec2pix_ring(torch.tensor(vec), order).numpy()
    agree = np.mean(pv == np.asarray(jaxhp.vec2pix_ring(jnp.asarray(vec),
                                                        order)))
    assert agree == 1.0, agree


@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("ndt,tdt,jdt", DTYPES)
def test_pix2vec_and_ring_decode_match_jaxhp(order, ndt, tdt, jdt):
    npix = 12 * 4**order
    nside = 1 << order
    pix = np.arange(npix)
    xj, yj, zj = jaxhp.pix2vec_ring_soa(jnp.asarray(pix), order, jdt)
    xt, yt, zt = torchhp.pix2vec_ring_soa(torch.tensor(pix), order, tdt)
    for a, b in ((xt, xj), (yt, yj), (zt, zj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=FTOL[ndt])
    v3 = torchhp.pix2vec_ring(torch.tensor(pix), order, tdt).numpy()
    np.testing.assert_allclose(
        v3, np.asarray(jaxhp.pix2vec_ring(jnp.asarray(pix), order, jdt)),
        rtol=0, atol=FTOL[ndt])
    rj, ij = jaxhp.ring_decode_pix(jnp.asarray(pix), nside, npix)
    rt, it = torchhp.ring_decode_pix(torch.tensor(pix), nside, npix)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    ir = np.arange(1, 4 * nside)
    gj = jaxhp._ring_geo_closed(jnp.asarray(ir, jnp.int32), nside, npix, jdt)
    gt = torchhp._ring_geo_closed(torch.tensor(ir), nside, npix, tdt)
    for k in range(3):  # startpix, ringpix, shift: exact
        np.testing.assert_array_equal(gt[k].numpy(), np.asarray(gj[k]))
    np.testing.assert_allclose(gt[3].numpy(), np.asarray(gj[3]), rtol=0,
                               atol=FTOL[ndt])


def test_isqrt_exact():
    # squares and their neighbours up to 46339^2 + 1: the JAX int32 version
    # overflows its (r + 1)^2 check beyond
    x = np.concatenate([np.arange(0, 5000), (np.arange(1, 46340) ** 2),
                        np.arange(1, 46340) ** 2 - 1,
                        np.arange(1, 46340) ** 2 + 1])
    got = torchhp._isqrt_dev(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jaxhp._isqrt_dev(jnp.asarray(x, jnp.int32))))
    assert np.all(got * got <= x) and np.all((got + 1) ** 2 > x)


@pytest.mark.parametrize("order", [2, 4, 6])
@pytest.mark.parametrize("ndt,tdt,jdt", DTYPES)
def test_get_interpol_soa_matches_jaxhp(order, ndt, tdt, jdt):
    vec = _random_vectors(3000, 100 + order, np.float64)
    th, ph = (np.array(x, ndt) for x in jaxhp.vec2ang(jnp.asarray(vec)))
    # include the exact poles and points next to them
    th[:4] = [0.0, np.pi, 1e-3, np.pi - 1e-3]
    # an azimuth weight is the fractional part of phi / dphi, a number up to
    # 4 nside: it carries the absolute rounding of that number (4 ulps)
    wtol = 4 * (4 << order) * np.finfo(ndt).eps
    (pj, wj) = jaxhp.get_interpol_soa(jaxhp.InterpTables(order, jdt),
                                      jnp.asarray(th), jnp.asarray(ph))
    (pt, wt) = torchhp.get_interpol_soa(
        torchhp.InterpTables(order), torch.tensor(th),
        torch.tensor(ph))
    for k in range(4):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
        np.testing.assert_allclose(wt[k].numpy(), np.asarray(wj[k]), rtol=0,
                                   atol=wtol)
    wsum = sum(w.numpy().astype(np.float64) for w in wt)
    np.testing.assert_allclose(wsum, 1.0, atol=wtol)


@pytest.mark.parametrize("order", [0, 5, 13])
def test_interp_tables_describe_the_jax_grid(order):
    tab = torchhp.InterpTables(order)
    jt = jaxhp.InterpTables(order, jnp.float64)
    assert (tab.order, tab.nside, tab.npix) == (jt.order, jt.nside, jt.npix)


def test_import_port_leaves_jax_unloaded():
    """Importing the whole port (every module) must not load jax."""
    code = (
        "import sys\n"
        "import calclens_tpu_torch.driver, calclens_tpu_torch.raytrace\n"
        "import calclens_tpu_torch.restart, calclens_tpu_torch.poisson\n"
        "import calclens_tpu_torch.sht.transforms, calclens_tpu_torch._ext\n"
        "import calclens_tpu_torch.sht.rings, calclens_tpu_torch.sht.czt\n"
        "from calclens_tpu_torch.driver import Raytracer\n"
        "from calclens_tpu.config import RayTraceConfig\n"
        "cfg = RayTraceConfig(maxComvDistance=100.0, NumLensPlanes=2,\n"
        "                     SHTOrder=2, rayOrder=2, bundleOrder=1)\n"
        "rt = Raytracer(cfg.finalize(), device='cpu')\n"
        "rt.init_rays()\n"
        "rt.step(0, pos=[[1.0, 0.0, 0.0]], mass=[1e12])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m.startswith('jaxlib'))\n"
        "print('JAXMODS', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
