"""Parity of the port's device HEALPix (calclens_tpu_torch.healpix.torchhp)
with calclens_tpu.healpix.jaxhp on the same numpy inputs.

Integer outputs (pixel ids, ring decode, tap ids) must be equal exactly;
float outputs agree to a few ulps of their dtype (tolerances below)."""
import os
import re
import subprocess
import sys

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


def _numpy_angles(vec):
    """theta, phi of vec by numpy's float64 arccos / arctan2."""
    v = np.asarray(vec, np.float64)
    r = np.linalg.norm(v, axis=-1)
    th = np.arccos(np.clip(v[..., 2] / r, -1.0, 1.0))
    ph = np.arctan2(v[..., 1], v[..., 0])
    return th, np.where(ph < 0.0, ph + 2.0 * np.pi, ph)


def _name_the_side_that_left(what, got_t, got_j, ref, tol):
    """Each side against numpy's float64 value, with the parity bound:
    the message says whether torch, JAX or both left it."""
    d_t = float(np.max(np.abs(np.asarray(got_t, np.float64) - ref)))
    d_j = float(np.max(np.abs(np.asarray(got_j, np.float64) - ref)))
    off = [name for name, d in (("torch", d_t), ("JAX", d_j)) if d > tol]
    assert not off, (f"{what}: {' and '.join(off)} left numpy's float64 "
                     f"value (torch {d_t:.3e}, JAX {d_j:.3e}, bound {tol:g})")


@pytest.mark.parametrize("order", [2, 4, 6])
@pytest.mark.parametrize("ndt,tdt,jdt", DTYPES)
def test_vec2ang_and_ang2pix_match_jaxhp(order, ndt, tdt, jdt):
    vec = _random_vectors(4000, order, ndt)
    th_j, ph_j = jaxhp.vec2ang(jnp.asarray(vec, jdt))
    th_t, ph_t = torchhp.vec2ang(torch.tensor(vec))
    # measured on these inputs: <= 3.6e-15 (float64) and 1.8e-6 (float32)
    # from numpy's theta, 8.9e-16 and 5.2e-7 from its phi, on both sides
    th_n, ph_n = _numpy_angles(vec)
    _name_the_side_that_left("theta", th_t.numpy(), np.asarray(th_j), th_n,
                             FTOL[ndt])
    _name_the_side_that_left("phi", ph_t.numpy(), np.asarray(ph_j), ph_n,
                             4 * FTOL[ndt])
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


def _port_sources():
    pkg = os.path.join(REPO, "calclens_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_import_port_leaves_jax_unloaded():
    """Importing every module of the port, and every module that
    chip_smoke.py imports (at any depth), then stepping a plane, loads
    neither jax nor the JAX package calclens_tpu."""
    code = (
        "import ast, importlib, pkgutil, sys\n"
        "import calclens_tpu_torch\n"
        "for mod in pkgutil.walk_packages(calclens_tpu_torch.__path__,\n"
        "                                 'calclens_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "with open('chip_smoke.py') as fp:\n"
        "    tree = ast.parse(fp.read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.Import):\n"
        "        for a in node.names:\n"
        "            importlib.import_module(a.name)\n"
        "    elif isinstance(node, ast.ImportFrom):\n"
        "        importlib.import_module(node.module)\n"
        "import chip_smoke\n"
        "from calclens_tpu_torch.config import RayTraceConfig\n"
        "from calclens_tpu_torch.driver import Raytracer\n"
        "cfg = RayTraceConfig(maxComvDistance=100.0, NumLensPlanes=2,\n"
        "                     SHTOrder=2, rayOrder=2, bundleOrder=1)\n"
        "rt = Raytracer(cfg.finalize(), device='cpu')\n"
        "rt.init_rays()\n"
        "rt.step(0, pos=[[1.0, 0.0, 0.0]], mass=[1e12])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or\n"
        "             m == 'calclens_tpu' or m.startswith('calclens_tpu.'))\n"
        "print('FORBIDDEN', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_never_name_the_jax_package_in_an_import():
    """No source of the port, and not chip_smoke.py, imports calclens_tpu
    (the port keeps its own copies of the host modules it needs)."""
    pat = re.compile(r"from calclens_tpu\.|import calclens_tpu\b")
    hits = []
    for path in _port_sources():
        with open(path) as fp:
            hits += [f"{path}:{i}" for i, line in enumerate(fp, 1)
                     if pat.search(line)]
    assert not hits, hits
    assert len(_port_sources()) > 20
