"""The fixed order of the port's scatter-adds (ops/deposit.add_at) on
inputs where many values meet in one element, so that the order of a
float32 sum shows: add_at against the JAX package's .at[].add, and every
deposit that goes through it (CIC, the SPH buckets, the MG patch deposit,
THREEDPOT's grid, the lens-map accumulation) against the JAX package's
deposit on the same inputs and against a float64 sum of the same values.

XLA's scatter-add on the CPU adds an element's values one after another
in input order, and so does add_at, on the CPU and on the card.

Tolerances: add_at on the same values gives JAX's bits, in float32 and in
float64.  The deposits in float64: 1e-12 of their max, as
tests/test_torch_deposit.py and test_torch_mg.py hold them (the weights
round apart by a few ulps); in float32 the deposits whose values both
packages compute alike give JAX's bits (NGP, THREEDPOT's grid, the lens
map's count and A rows: its ra and dec rows take theta by another
formula, tests/test_torch_maps.py), and every add_at of a float32 deposit
lies within the bound of a sequential float32 sum, (k - 1) 2^-24 times the
sum of the k magnitudes, of the float64 sum of the same values."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu import fftpot as jf
from calclens_tpu import maps as jmaps
from calclens_tpu import mgdriver as jmgd
from calclens_tpu.healpix import jaxhp
from calclens_tpu.ops import deposit as jdep
from calclens_tpu_torch import fftpot as tf
from calclens_tpu_torch import maps as tmaps
from calclens_tpu_torch import mgdriver as tmgd
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.ops import deposit as tdep

F64_BOUND = 1e-12
U32 = 2.0**-24


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread (the suite's workers run
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crowd(n, seed):
    """n particles in a cap of a few degrees around one direction (a few
    HEALPix cells at the orders below), radii 400-800, masses 1e12-5e13."""
    rng = np.random.default_rng(seed)
    c = np.array([0.3, 0.4, 0.866])
    v = c / np.linalg.norm(c) + 0.03 * rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * rng.uniform(400.0, 800.0, (n, 1)), rng.uniform(1e12, 5e13, n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows", [False, True])
def test_add_at_is_jax_scatter_add(dtype, rows):
    """50,000 values over 37 elements (a [7, 37] map along dim 1 with
    rows), magnitudes over 8 decades: JAX's .at[].add bits; and within the
    sequential-sum bound of the float64 sum."""
    rng = np.random.default_rng(7)
    n, m = 50_000, 37
    idx = rng.integers(0, m, n)
    shape = (7, n) if rows else (n,)
    vals = (rng.lognormal(0.0, 3.0, shape)
            * rng.choice([-1.0, 1.0], shape)).astype(dtype)
    zeros = np.zeros((7, m) if rows else (m,), dtype)
    jidx = (slice(None), jnp.asarray(idx)) if rows else jnp.asarray(idx)
    ref = np.asarray(jnp.asarray(zeros).at[jidx].add(jnp.asarray(vals)))
    got = tdep.add_at(torch.tensor(zeros), torch.tensor(idx),
                      torch.tensor(vals), dim=1 if rows else 0).numpy()
    np.testing.assert_array_equal(got, ref)
    v2 = vals.reshape(-1, n).astype(np.float64)
    exact = np.stack([np.bincount(idx, weights=r, minlength=m) for r in v2])
    mags = np.stack([np.bincount(idx, weights=np.abs(r), minlength=m)
                     for r in v2])
    k = np.bincount(idx, minlength=m)
    eps = np.finfo(dtype).eps / 2
    assert np.all(np.abs(got.reshape(exact.shape) - exact)
                  <= (k - 1) * eps * mags + 1e-300)


@pytest.fixture
def spy(monkeypatch):
    """Every add_at of the port's deposits and lens maps, recorded: its
    float32 result against the float64 sum of its values, within the
    sequential-sum bound (on an out of zeros, as every caller here gives
    it).  Returns the list of (k, worst |error| / bound) per call."""
    calls = []
    add_at = tdep.add_at

    def checked(out, idx, vals, dim=0):
        assert not bool(out.any())
        got = add_at(out, idx, vals, dim)
        if got.dtype == torch.float32:
            v = vals.movedim(dim, -1).reshape(-1, vals.shape[dim])
            v = v.double().numpy()
            i, m = idx.numpy(), got.shape[dim]
            exact = np.stack([np.bincount(i, weights=r, minlength=m)
                              for r in v])
            mags = np.stack([np.bincount(i, weights=np.abs(r), minlength=m)
                             for r in v])
            k = np.bincount(i, minlength=m)
            err = np.abs(got.movedim(dim, -1).reshape(exact.shape).double()
                         .numpy() - exact)
            bound = np.maximum(k - 1, 0) * U32 * mags
            assert np.all(err <= bound), float((err - bound).max())
            calls.append((int(k.max()), float((err / np.maximum(
                bound, 1e-300)).max())))
        return got

    for mod in (tdep, tmaps, tmgd, tf):
        monkeypatch.setattr(mod, "add_at", checked)
    return calls


def _jt(dtype):
    return jnp.float32 if dtype == np.float32 else jnp.float64


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cic_and_sph_deposits_in_few_cells(spy, dtype):
    """20,000 particles in ~14 pixels at order 3: CIC, the SPH buckets
    with CIC and NGP placement, and NGP with unequal masses."""
    pos, mass = (x.astype(dtype) for x in _crowd(20_000, 3))
    order, npix = 3, 12 * 4**3
    sl = np.exp(np.random.default_rng(4).uniform(
        np.log(0.01), np.log(0.4), len(pos))).astype(dtype)
    sigmas = tdep.sph_sigma_grid(0.02, 0.2, 8)
    jtab, ttab = jaxhp.InterpTables(order, _jt(dtype)), \
        torchhp.InterpTables(order)
    P, M, S = (jnp.asarray(x) for x in (pos, mass, sl))
    p, m, s = (torch.tensor(x) for x in (pos, mass, sl))
    pairs = {
        "cic": (jdep.deposit_cic(jtab, P, M), tdep.deposit_cic(ttab, p, m)),
        "sph cic": (jdep.deposit_sph_bucketed(order, P, M, S, sigmas, npix,
                                              tab=jtab),
                    tdep.deposit_sph_bucketed(order, p, m, s, sigmas, npix,
                                              tab=ttab)),
        "sph ngp": (jdep.deposit_sph_bucketed(order, P, M, S, sigmas, npix),
                    tdep.deposit_sph_bucketed(order, p, m, s, sigmas, npix)),
        "ngp": (jdep.deposit_ngp(order, P, M, npix),
                tdep.deposit_ngp(order, p, m, npix))}
    for name, (ref, got) in pairs.items():
        ref, got = np.asarray(ref), got.numpy()
        assert got.dtype == dtype, name
        if dtype == np.float64:
            np.testing.assert_allclose(got, ref, rtol=0, atol=F64_BOUND
                                       * np.abs(ref).max(), err_msg=name)
        else:
            assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), name
    if dtype == np.float32:
        np.testing.assert_array_equal(*(np.asarray(x)
                                        for x in pairs["ngp"]))
        assert len(spy) == 4 and min(k for k, _ in spy) > 1000


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mg_patch_deposit_in_few_cells(spy, dtype):
    """The CIC patch deposit of 20,000 particles in a few cells of bundle
    order 1 (16^2-cell patches)."""
    pos, mass = (x.astype(dtype) for x in _crowd(20_000, 5))
    js = jmgd.MGSetup(1, 16, 4, dtype=_jt(dtype))
    ts = tmgd.MGSetup(1, 16, 4, dtype=torch.tensor(pos).dtype)
    ref = np.asarray(jmgd.deposit_patches(js, jnp.asarray(pos),
                                          jnp.asarray(mass), 2.5e-13, 0.3))
    got = tmgd.deposit_patches(ts, torch.tensor(pos), torch.tensor(mass),
                               2.5e-13, 0.3).numpy()
    tol = F64_BOUND if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    if dtype == np.float32:
        assert len(spy) == 1 and spy[0][0] > 100


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_threedpot_grid_in_few_cells(spy, dtype):
    """20,000 particles in a clump of a few cells of a 16^3 grid: JAX's
    counts bit for bit (both in float32)."""
    pos = (100.0 + 3.0 * np.random.default_rng(6).normal(
        size=(20_000, 3))).astype(dtype)
    ref = np.asarray(jf.cic_deposit_3d(jnp.asarray(pos), 16,
                                       jnp.asarray(200.0, _jt(dtype))))
    got = tf.cic_deposit_3d(torch.from_numpy(pos), 16, 200.0).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(spy) == 1 and spy[0][0] > 1000


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lens_map_accumulation_in_few_pixels(spy, dtype):
    """20,000 rays on 12 coarse pixels (the general path's add along dim
    1): the count and A rows JAX's bits; ra and dec within 1e-6 of their
    max (theta by atan2 in the port, arccos in JAX)."""
    rng = np.random.default_rng(8)
    packed = rng.normal(size=(21, 20_000)).astype(dtype)
    lpix = rng.integers(0, 12, 20_000)
    zeros = np.zeros((7, 12), dtype)
    ref = np.asarray(jmaps.update_lens_map_stacked(
        jnp.asarray(zeros), jnp.asarray(packed), jnp.asarray(lpix)))
    got = tmaps.update_lens_map_stacked(torch.tensor(zeros),
                                        torch.tensor(packed),
                                        torch.tensor(lpix)).numpy()
    np.testing.assert_array_equal(got[:5], ref[:5])
    for r in (5, 6):
        assert np.abs(got[r] - ref[r]).max() <= 1e-6 * np.abs(ref[r]).max()
    assert len(spy) == (1 if dtype == np.float32 else 0)
