"""Paths of the port that the other parity tests leave out, each against
the JAX package on the same numpy inputs in float64 (ROADMAP Queue 3): a
non-default lmax, quadrature ring weights, and rayOrder at or above
SHTOrder.  Tolerances as in tests/test_torch_sht.py and
tests/test_torch_raytrace.py: 1e-10 of the reference's max |value| for a
transform, 1e-9 per packed row for a trace."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.config import RayTraceConfig
from calclens_tpu import driver as jdriver
from calclens_tpu.sht import transforms as JT
from calclens_tpu.sht.plan import SHTPlan as JPlan
from calclens_tpu_torch import driver as tdriver
from calclens_tpu_torch.sht import transforms as T
from calclens_tpu_torch.sht.plan import SHTPlan


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _plans(order, **kw):
    jp = JPlan(order, dtype=jnp.float64, **kw)
    jp.use_pallas = False
    tp = SHTPlan(order, "cpu", dtype=torch.float64, **kw)
    jp.synthesis_rings_mode = tp.synthesis_rings_mode
    return jp, tp


def test_lmax_40_at_order_5_matches_jax():
    jp, tp = _plans(5, lmax=40)
    assert (tp.nl, tp.nm) == (41, 41)
    rng = np.random.default_rng(300)
    m = rng.normal(size=tp.npix)
    ref = np.asarray(JT.map2alm(jp, jnp.asarray(m)))
    got = T.map2alm(tp, torch.tensor(m)).numpy()
    assert got.shape == ref.shape == (41, 41)
    assert _relerr(got, ref) < 1e-10
    ref6 = np.stack([np.asarray(x) for x in JT.alm2allmaps(jp,
                                                            jnp.asarray(ref))])
    got6 = T.alm2allmaps(tp, torch.tensor(ref)).numpy()
    for k in range(6):
        assert _relerr(got6[k], ref6[k]) < 1e-10, k


def test_ring_weights_at_order_5_match_jax():
    rw = 1.0 + 0.05 * np.sin(np.arange(2 * 32) * 0.7)
    jp, tp = _plans(5, ring_weights=rw)
    m = np.random.default_rng(301).normal(size=tp.npix)
    ref = np.asarray(JT.map2alm(jp, jnp.asarray(m)))
    got = T.map2alm(tp, torch.tensor(m)).numpy()
    assert _relerr(got, ref) < 1e-10
    # the weights matter: without them the alm differ
    plain = SHTPlan(5, "cpu", dtype=torch.float64)
    assert _relerr(T.map2alm(plain, torch.tensor(m)).numpy(), ref) > 1e-3


def _row_err(got, ref):
    """Max over packed rows of |got - ref| / the max |value| of the row's
    quantity (n, beta, A, Aprev, alpha, U, phi)."""
    groups = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return max(np.abs(got[a:b] - ref[a:b]).max()
               / (np.abs(ref[a:b]).max() + 1e-300) for a, b in groups)


@pytest.mark.parametrize("sht_order,ray_order", [(4, 6), (5, 5)])
def test_ray_order_at_or_above_sht_order_matches_jax(sht_order, ray_order):
    """Two planes from one state, rays at least as fine as the SHT map."""
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
                         SHTOrder=sht_order, rayOrder=ray_order,
                         bundleOrder=2, Precision="f64").finalize()
    jrt = jdriver.Raytracer(cfg)
    jrt.init_rays()
    trt = tdriver.Raytracer(cfg, device="cpu")
    jrt.plan.synthesis_rings_mode = trt.plan.synthesis_rings_mode
    trt.load_state(np.asarray(jrt.rays_packed), 1, 0)
    rng = np.random.default_rng(302)
    for p in (1, 2):
        v = rng.normal(size=(2000, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pos = v * (250.0 * p + rng.uniform(0.0, 250.0, size=(2000, 1)))
        mass = rng.uniform(1e12, 5e13, size=2000)
        jrt.step(p, pos=pos, mass=mass)
        trt.step(p, pos=pos, mass=mass)
        ref = np.asarray(jrt.rays_packed)
        assert np.abs(ref[14:16]).max() > 0  # deflected
        assert _row_err(trt.rays_packed.numpy(), ref) < 1e-9, p
