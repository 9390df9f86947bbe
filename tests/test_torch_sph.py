"""The SPH plane step through the port's driver, against calclens_tpu on
the same numpy inputs (float64): a 3-plane trace at SHTOrder 6 / rayOrder
5 in a box, the driver's sigma grid, and a full-sky Profile run whose
SHTSOLVE phase holds the eight per-bucket analyses.

Tolerance: 1e-9 of each quantity's max per plane (two FFT libraries and
summation orders through eight analyses and the synthesis, as
tests/test_torch_raytrace.py); the Profile'd run equals the plain run bit
for bit (the same calls)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.config import RayTraceConfig
from calclens_tpu import driver as jdriver
from calclens_tpu_torch import driver as tdriver
from calclens_tpu_torch import poisson as tpoisson

GROUPS = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))


def _row_err(got, ref):
    """Max over packed rows of |got - ref| / max |ref| of the row's
    quantity (n, beta, A, Aprev, alpha, U, phi)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    worst = 0.0
    for a, b in GROUPS:
        scale = np.abs(ref[a:b]).max() + 1e-300
        worst = max(worst, float(np.abs(got[a:b] - ref[a:b]).max() / scale))
    return worst


def _cfg(**kw):
    base = dict(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
                SHTOrder=6, rayOrder=5, bundleOrder=2, Precision="f64",
                DepositScheme="SPH")
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _plane_particles(p, seed=57, n=3000):
    rng = np.random.default_rng(seed + p)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rad = (p + rng.uniform(0.0, 1.0, size=(n, 1))) * 250.0
    return v * rad, rng.uniform(1e12, 5e13, size=n)


def test_sph_trace_matches_jax_plane_by_plane():
    """Both drivers from init_rays in a box (the cut-sky buffer is built
    from float64 pixel vectors on both sides) over planes 1-3, plane 2
    empty.  The box takes every branch of the SPH deposit: bucket 0 carries
    -backdens on the live pixels (on the full sky it is a monopole, which
    the filter zeroes)."""
    cfg = _cfg(minRa=20.0, maxRa=80.0, minDec=-30.0, maxDec=30.0,
               ComvSmoothingScale=15.0)
    jrt = jdriver.Raytracer(cfg)
    trt = tdriver.Raytracer(cfg, device="cpu")
    assert trt.sph == jrt.sph and len(trt.sph) == 11
    jrt.init_rays()
    trt.init_rays()
    np.testing.assert_array_equal(trt.rays_packed.numpy(),
                                  np.asarray(jrt.rays_packed))
    for p in (1, 2, 3):
        pos, mass = _plane_particles(p) if p != 2 else ([], [])
        jrt.step(p, pos=pos, mass=mass)
        trt.step(p, pos=pos, mass=mass)
        err = _row_err(trt.rays_packed.numpy(), jrt.rays_packed)
        assert err < 1e-9, (p, err)
    assert np.abs(trt.rays_packed[14:16].numpy()).max() > 0  # deflected
    np.testing.assert_array_equal(trt.ray_nest, jrt.ray_nest)


def test_sph_params_match_jax():
    """The driver's static tuple (8 sigmas, csl, min_sl, max_sl) for the
    default csl, a set one, and a csl whose max_sl clamps at pi / 2 and at
    2 min_sl."""
    for kw in ({}, dict(ComvSmoothingScale=3.0),
               dict(ComvSmoothingScale=1e4), dict(ComvSmoothingScale=1e-3),
               dict(rayOrder=3, SHTOrder=4)):
        cfg = _cfg(**kw)
        ref = jdriver.Raytracer(cfg).sph
        assert tdriver.sph_params(cfg) == ref, kw


def test_sph_profile_row_holds_the_eight_analyses(monkeypatch):
    """In Profile mode each SPH plane runs eight map2alm calls, all inside
    its SHTSOLVE phase, and gives the plain run's rays bit for bit; the
    windows are built once per plan."""
    calls = []
    current = [None]
    real_map2alm = tpoisson.T.map2alm

    def map2alm(plan, m):
        calls.append(current[0])
        return real_map2alm(plan, m)

    monkeypatch.setattr(tpoisson.T, "map2alm", map2alm)
    plain = tdriver.Raytracer(_cfg(SHTOrder=5, rayOrder=4), device="cpu")
    prof = tdriver.Raytracer(_cfg(SHTOrder=5, rayOrder=4, Profile=True),
                             device="cpu")
    real_timed = prof._timed_phase

    def timed(plane_num):
        phase = real_timed(plane_num)

        def tagged(tag, fn, *args):
            current[0] = tag
            try:
                return phase(tag, fn, *args)
            finally:
                current[0] = None
        return tagged

    prof._timed_phase = timed
    for rt in (plain, prof):
        rt.init_rays()
    for p in (1, 2):
        pos, mass = _plane_particles(p, n=1000)
        plain.step(p, pos=pos, mass=mass)
        builds = plain.plan.tables.builds
        calls.clear()
        prof.step(p, pos=pos, mass=mass)
        assert calls == ["SHTSOLVE"] * 8, calls
        assert torch.equal(plain.rays_packed, prof.rays_packed), p
    assert plain.plan.tables.builds == builds
    rows = dict(prof.phase_rows)
    assert sorted(rows) == [1, 2]
    for p in (1, 2):
        assert sorted(rows[p]) == ["DEPOSIT", "RAYPROP", "SHT", "SHTSOLVE"]
        assert all(t > 0 for t in rows[p].values())
