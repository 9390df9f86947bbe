"""The port's CIC and SPH deposits, their windows and the masked scaling
against calclens_tpu on the same numpy inputs (float64), and the bucketed
SPH scheme against the exact per-particle reference algorithm
(calclens_tpu/testing/sph_oracle.py) under tests/test_sph_deposit.py's own
bounds.

Tolerances: bilinear tap indices exact; weights 4 * 4 nside ulps (an
azimuth weight is the fractional part of phi / dphi, a number up to
4 nside, as tests/test_torch_healpix.py bounds the unstacked taps);
deposited maps 1e-12 of their max (the same sums, colliding particles added
in another order); the windows bit for bit (the same float64
recurrence)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.special import eval_legendre

from calclens_tpu.healpix import jaxhp
from calclens_tpu.ops import deposit as jdep
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.ops import deposit as tdep


def _particles(n, seed, poles=True):
    """n particles at random directions and radii, the first ones at the
    poles and on the x axis (each pole's tap fold)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    if poles:
        v[:4] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1e-9, 0.0, 1.0],
                 [1.0, 0.0, 0.0]]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = rng.uniform(300.0, 1200.0, size=n)
    return v * r[:, None], rng.uniform(1e12, 5e13, size=n)


@pytest.mark.parametrize("order", [4, 5, 6])
def test_get_interpol_matches_jax(order):
    pos, _ = _particles(4000, order)
    th, ph = (np.asarray(x) for x in jaxhp.vec2ang(jnp.asarray(pos)))
    pj, wj = jaxhp.get_interpol(jaxhp.InterpTables(order, jnp.float64),
                                jnp.asarray(th), jnp.asarray(ph))
    pt, wt = torchhp.get_interpol(torchhp.InterpTables(order),
                                  torch.tensor(th), torch.tensor(ph))
    assert pt.shape == wt.shape == (4000, 4) and pt.dtype == torch.int64
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=4 * (4 << order) * np.finfo(np.float64).eps)


@pytest.mark.parametrize("order", [4, 5, 6])
def test_deposit_cic_matches_jax(order):
    pos, mass = _particles(5000, 10 + order)
    ref = np.asarray(jdep.deposit_cic(jaxhp.InterpTables(order, jnp.float64),
                                      jnp.asarray(pos), jnp.asarray(mass)))
    got = tdep.deposit_cic(torchhp.InterpTables(order), torch.tensor(pos),
                           torch.tensor(mass)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    assert np.isclose(got.sum(), mass.sum() / tdep.MASS_SCALE, rtol=1e-12)


def _sph_inputs(order, seed):
    """Particles whose smoothing lengths sit below min_sl, at min_sl, at
    every bucket sigma (t = 0 or 1), between buckets, at max_sl and above
    it: sl = csl / r, so the radius sets sl."""
    min_sl, max_sl, csl = 0.02, 0.2, 40.0
    sigmas = tdep.sph_sigma_grid(min_sl, max_sl, 8)
    pos, mass = _particles(3000, seed)
    v = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    sl = np.exp(np.random.default_rng(seed).uniform(
        np.log(0.5 * min_sl), np.log(2.0 * max_sl), size=len(v)))
    sl[4:4 + len(sigmas)] = sigmas
    sl[20:24] = [min_sl, max_sl, 0.1 * min_sl, 10.0 * max_sl]
    return v * (csl / sl)[:, None], mass, sigmas, (csl, min_sl, max_sl)


@pytest.mark.parametrize("order", [4, 5, 6])
@pytest.mark.parametrize("cic", [True, False])
def test_deposit_sph_bucketed_matches_jax(order, cic):
    pos, mass, sigmas, (csl, min_sl, max_sl) = _sph_inputs(order, 20 + order)
    npix = 12 * 4**order
    sl_j = jdep.smoothing_lengths(jnp.asarray(pos), csl, min_sl, max_sl)
    sl_t = tdep.smoothing_lengths(torch.tensor(pos), csl, min_sl, max_sl)
    # the clamps hold min_sl and max_sl exactly
    assert np.all(sl_t.numpy() >= min_sl) and np.all(sl_t.numpy() <= max_sl)
    assert np.sum(sl_t.numpy() == min_sl) >= 2
    assert np.sum(sl_t.numpy() == max_sl) >= 2
    np.testing.assert_allclose(sl_t.numpy(), np.asarray(sl_j), rtol=1e-15,
                               atol=0)
    # the same smoothing lengths into both deposits, so the buckets and t
    # at the bucket edges are decided alike
    sl = np.asarray(sl_j)
    ref = np.asarray(jdep.deposit_sph_bucketed(
        order, jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(sl), sigmas,
        npix, tab=jaxhp.InterpTables(order, jnp.float64) if cic else None))
    got = tdep.deposit_sph_bucketed(
        order, torch.tensor(pos), torch.tensor(mass), torch.tensor(sl),
        sigmas, npix, tab=torchhp.InterpTables(order) if cic else None)
    assert got.shape == (8, npix)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    assert np.isclose(got.sum(), mass.sum() / tdep.MASS_SCALE, rtol=1e-12)
    # a smoothing length equal to a bucket sigma (t = 0 or 1) puts all of
    # the particle's mass into that bucket
    for b in (0, 3, 7):
        one = tdep.deposit_sph_bucketed(
            order, torch.tensor(pos[4:5]), torch.tensor(mass[4:5]),
            torch.tensor(sigmas[b:b + 1]), sigmas, npix).numpy()
        assert np.flatnonzero(one.sum(axis=1)).tolist() == [b]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scale_density_with_vacuum_mask_matches_jax(dtype):
    rng = np.random.default_rng(5)
    npix = 12 * 4**5
    dens = rng.uniform(0.0, 3.0, size=npix).astype(dtype)
    vac = rng.random(npix) < 0.4
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    args = (3.0e-4, 2.0e-3, 4 * np.pi / npix)
    ref = np.asarray(jdep.scale_density(
        jnp.asarray(dens), jnp.asarray(args[0], jdt),
        jnp.asarray(args[1], jdt), args[2], jnp.asarray(vac)))
    got = tdep.scale_density(torch.tensor(dens), torch.tensor(args[0],
                                                              dtype=tdt),
                             torch.tensor(args[1], dtype=tdt), args[2],
                             torch.tensor(vac)).numpy()
    assert np.all(got[vac] == 0.0) and np.all(got[~vac] != 0.0)
    np.testing.assert_allclose(got, ref, rtol=4 * np.finfo(dtype).eps,
                               atol=4 * np.finfo(dtype).eps * np.abs(ref).max())


def test_legendre_table_equals_eval_legendre():
    x = np.concatenate([np.cos(np.linspace(0.0, np.pi, 257)),
                        [1.0, -1.0, 0.0, 3e-6, -9e-6, 2e-5],
                        np.random.default_rng(3).uniform(-1, 1, 64)])
    lmax = 700
    ref = eval_legendre(np.arange(lmax + 1)[:, None], x[None, :])
    np.testing.assert_array_equal(tdep.legendre_table(lmax, x), ref)
    np.testing.assert_array_equal(tdep.legendre_table(0, x), ref[:1])


@pytest.mark.parametrize("lmax", [1, 95, 383])
def test_windows_equal_jax(lmax):
    for sigma in (5e-4, 0.02, 0.2, np.pi / 2):
        np.testing.assert_array_equal(tdep.kernel_bl(sigma, lmax),
                                      jdep.kernel_bl(sigma, lmax))
    for order in (3, 5, 7):
        np.testing.assert_array_equal(tdep.pixwin_disc_bl(order, lmax),
                                      jdep.pixwin_disc_bl(order, lmax))
    sig = tdep.sph_sigma_grid(0.01, 0.3, 8)
    np.testing.assert_array_equal(sig, jdep.sph_sigma_grid(0.01, 0.3, 8))
    # phase_analysis_sph's windows, as the JAX package forms them
    from calclens_tpu_torch.poisson import sph_windows
    from calclens_tpu_torch.sht.plan import SHTPlan

    plan = SHTPlan(5, "cpu", lmax=lmax, dtype=torch.float64)
    w = sph_windows(plan, sig)
    assert w.shape == (8, lmax + 1) and w.dtype == torch.float64
    for b in (0, 2, 7):
        np.testing.assert_array_equal(
            w[b].numpy(), jdep.kernel_bl(float(sig[b]), lmax)
            / jdep.pixwin_disc_bl(5, lmax) ** 2)
    assert sph_windows(plan, sig) is w  # built once per plan


def _bucketed_vs_oracle_err(order, min_sl, max_sl, csl, seed=7):
    """tests/test_sph_deposit.py::_bucketed_vs_oracle_err through the port:
    the deflection-field RMS error of the bucketed scheme (the port's
    deposit_sph_bucketed, then phase_analysis_sph's windows) against the
    exact per-particle reference deposit, both through the port's SHT."""
    from calclens_tpu.testing import sph_oracle
    from calclens_tpu_torch import poisson as tpoisson
    from calclens_tpu_torch.sht import transforms as T
    from calclens_tpu_torch.sht.plan import SHTPlan

    plan = SHTPlan(order, "cpu", dtype=torch.float64)
    tab = torchhp.InterpTables(order)
    rng = np.random.default_rng(seed)
    N = 150
    vec = rng.normal(size=(N, 3))
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    r = rng.uniform(400.0, 1000.0, N)
    pos = vec * r[:, None]
    mass = rng.uniform(0.5, 2.0, N) * 1e14
    sl = np.clip(csl / r, min_sl, max_sl)
    dens_exact = sph_oracle.deposit_sph_exact(order, pos, mass, sl)
    alm_e = tpoisson._poisson_filter(
        plan, T.map2alm(plan, torch.tensor(dens_exact)))
    sigmas = tdep.sph_sigma_grid(min_sl, max_sl, 8)
    dens_b = tdep.deposit_sph_bucketed(order, torch.tensor(pos),
                                       torch.tensor(mass), torch.tensor(sl),
                                       sigmas, plan.npix, tab=tab)
    alm_b = tpoisson.phase_analysis_sph(plan, dens_b, sigmas)
    out_b = T.alm2allmaps(plan, alm_b)
    out_e = T.alm2allmaps(plan, alm_e)
    errs = []
    for comp in (1, 2):  # d_theta, d_phi
        gb, ge = out_b[comp].numpy(), out_e[comp].numpy()
        errs.append(float(np.sqrt(np.mean((gb - ge) ** 2)
                                  / np.mean(ge ** 2))))
    return errs


def test_sph_bucketed_vs_exact_oracle_through_port():
    """tests/test_sph_deposit.py::test_sph_bucketed_vs_exact_oracle's
    bounds: < 1 % at sigma = 4.7-11.7 pixels, < 2.5 % at 2.3-6.2."""
    errs = _bucketed_vs_oracle_err(6, 0.06, 0.15, 60.0)
    assert max(errs) < 0.01, errs
    errs2 = _bucketed_vs_oracle_err(6, 0.03, 0.08, 30.0)
    assert max(errs2) < 0.025, errs2
