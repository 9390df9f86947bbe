"""The port's multigrid refinement (calclens_tpu_torch/mg.py, mgdriver.py,
poisson.plane_step_mg and the driver's non-SHTONLY branch) against the JAX
package's on the same numpy inputs, float64 on the CPU.

Each quantity is held to 1e-10 of its max |value| over the compared set;
the adaptive solve must take the JAX loop's cycle count.  The patches are
small (fine interiors 8-64, bundleOrder 1-2) to keep the file within its
CPU budget; the point-mass trace presets both drivers' patch tables
(Raytracer.mgsetup) at interior 32 instead of the driver's 128."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu import mg as jmg
from calclens_tpu import mgdriver as jmgd
from calclens_tpu.config import RayTraceConfig
from calclens_tpu.healpix import core as hp
from calclens_tpu.healpix import jaxhp
from calclens_tpu_torch import mg as tmg
from calclens_tpu_torch import mgdriver as tmgd
from calclens_tpu_torch.healpix import torchhp

REL = 1e-10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread: its tensors here are small,
    and under the suite's parallel workers torch's per-process thread pools
    would oversubscribe the cores (several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err < REL, f"{what}: {err:.3e} of max |ref| {scale:.3e}"


def _batch(C, n, seed):
    """Levels of a 0.2 rad patch with interior n (JAX's, the port's), a
    smooth field with its Dirichlet ghost ring (u0), the field's Laplacian
    plus noise (rhs) and a random field."""
    levels = tuple(jmg.build_levels(0.2, n))
    tlevels = tuple(tmg.build_levels(0.2, n))
    assert [dataclasses.astuple(x) for x in tlevels] == \
        [dataclasses.astuple(x) for x in levels]
    lev = levels[0]
    N = lev.N
    rng = np.random.default_rng(seed)
    th = np.arange(N) * lev.dL + lev.thetaLoc
    ph = np.arange(N) * lev.dL + lev.phiLoc
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    k = rng.uniform(5, 30, size=(C, 4))
    u = (np.sin(k[:, 0, None, None] * (TH - np.pi / 2))
         * np.cos(k[:, 1, None, None] * PH)
         + np.cos(k[:, 2, None, None] * PH + k[:, 3, None, None] * TH))
    rhs = np.asarray(jmg.lop(jnp.asarray(u), lev)) \
        + 10.0 * rng.normal(size=u.shape)
    ghost = np.ones((N, N))
    ghost[1:-1, 1:-1] = 0
    return (levels, tlevels), u * ghost, rhs, rng.normal(size=(C, N, N))


@pytest.mark.parametrize("C,n", [(2, 16), (4, 64)])
def test_operators_match_jax(C, n):
    import jax

    (jl, tl), u0, rhs, x = _batch(C, n, n)
    xc = np.random.default_rng(1).normal(size=(C, jl[1].N, jl[1].N))

    def ops(mod, levels, u0, rhs, x, xc):
        return (mod.lop(x, levels[0]), mod.rbgs(x, rhs, levels[0], 3),
                mod.restrict_full(x), mod.prolong_add(x, xc),
                mod.vcycle(x, rhs, levels, 0, 2, 2),
                mod.solve_fas(u0, rhs, levels, 4, 2, 2),
                mod._truncation_norm(x, rhs, levels))

    # the JAX operators as one compiled program
    ref = jax.jit(lambda *a: ops(jmg, jl, *a))(
        *(jnp.asarray(a) for a in (u0, rhs, x, xc)))
    tx = torch.tensor(x)
    got = ops(tmg, tl, torch.tensor(u0), torch.tensor(rhs), tx,
              torch.tensor(xc))
    for g, r, what in zip(got, ref, ("lop", "rbgs", "restrict_full",
                                     "prolong_add", "vcycle", "solve_fas",
                                     "truncation norm")):
        close(g, r, what)
    # the functional forms leave their inputs as they were
    np.testing.assert_array_equal(tx.numpy(), x)
    assert tmg.patch_interior_sizes(n) == jmg.patch_interior_sizes(n)
    for L, msl in ((0.4, 0.4 / 128), (0.26, 0.0041), (0.05, 0.003)):
        assert tmg.choose_patch_n(L, msl, 64, 256) == \
            jmg.choose_patch_n(L, msl, 64, 256)


def _jax_adaptive_cycles(u0, rhs, levels, conv_fact, max_cycles):
    """The JAX while_loop's trip count, by its cond and body run one at a
    time."""
    import jax

    lev = levels[0]
    mask = jmg._interior_mask(lev, u0.dtype)

    @jax.jit
    def done(u):
        taun = jmg._truncation_norm(u, rhs, levels)
        res = jnp.sum(jnp.abs((rhs - jmg.lop(u, lev)) * mask), axis=(-2, -1))
        return jnp.all(res <= conv_fact * jnp.maximum(taun, 1e-300))

    cycle = jax.jit(lambda u: jmg.vcycle(u, rhs, levels, 0, 2, 2))
    u, k = u0, 0
    while k < max_cycles and not bool(done(u)):
        u = cycle(u)
        k += 1
    return k


@pytest.mark.parametrize("conv_fact", [0.1, 0.01])
def test_adaptive_solve_takes_the_jax_cycle_count(conv_fact):
    (levels, tl), u0, rhs, _ = _batch(3, 16, 7)
    u_t, k_t = tmg.solve_fas_adaptive(torch.tensor(u0), torch.tensor(rhs),
                                      tl, conv_fact, 20)
    u_j = jmg.solve_fas_adaptive(jnp.asarray(u0), jnp.asarray(rhs), levels,
                                 conv_fact, 20)
    k_j = _jax_adaptive_cycles(jnp.asarray(u0), jnp.asarray(rhs), levels,
                               conv_fact, 20)
    assert k_t == k_j and 1 < k_t < 20, (k_t, k_j)
    close(u_t, u_j, "adaptive u")
    # the JAX solve took k_j cycles: its u is the fixed solve's of k_j
    close(u_t, jmg.solve_fas(jnp.asarray(u0), jnp.asarray(rhs), levels, k_j,
                             2, 2), "fixed solve of the same cycles")


def _setups(bundle_order, n, ray_order):
    return (jmgd.MGSetup(bundle_order, n, ray_order, dtype=jnp.float64),
            tmgd.MGSetup(bundle_order, n, ray_order, dtype=torch.float64))


@pytest.mark.parametrize("bundle_order,n", [(1, 16), (2, 8)])
def test_patch_deposits_match_jax(bundle_order, n):
    js, ts = _setups(bundle_order, n, 4)
    np.testing.assert_array_equal(ts.R9, js.R9)
    np.testing.assert_array_equal(ts.neighbors, js.neighbors)
    rng = np.random.default_rng(bundle_order)
    vec = rng.normal(size=(300, 3))
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    pos = vec * rng.uniform(200, 800, size=(300, 1))
    mass = rng.uniform(1.0, 2.0, 300) * 1e12
    lev = js.levels[0]
    close(tmgd.deposit_patches(ts, torch.tensor(pos), torch.tensor(mass),
                               2.5e-13, 0.3),
          jmgd.deposit_patches(js, jnp.asarray(pos), jnp.asarray(mass),
                               2.5e-13, 0.3), "deposit_patches")
    # stamps from one cell up to wider than the patch (cropped in the port)
    sigmas = (0.7 * lev.dL, 2.5 * lev.dL, 6 * lev.dL, 1.5 * lev.N * lev.dL)
    sl = rng.uniform(sigmas[0], sigmas[-1], 300)
    close(tmgd.deposit_patches_sph(ts, torch.tensor(pos), torch.tensor(mass),
                                   torch.tensor(sl), 2.5e-13, 0.3, sigmas),
          jmgd.deposit_patches_sph(js, jnp.asarray(pos), jnp.asarray(mass),
                                   jnp.asarray(sl), 2.5e-13, 0.3, sigmas),
          "deposit_patches_sph")


@pytest.mark.parametrize("bundle_order,n,ray_order", [(1, 16, 4), (2, 8, 5)])
def test_bc_fill_and_ray_derivatives_match_jax(bundle_order, n, ray_order,
                                               monkeypatch):
    js, ts = _setups(bundle_order, n, ray_order)
    order = 4
    rng = np.random.default_rng(11)
    potmap = rng.normal(size=int(hp.order2npix(order)))
    # chunks of 3 cells: the port's chunked fill equals the whole one
    monkeypatch.setattr(tmgd, "FILL_CHUNK_ELEMS", 3 * js.levels[0].N ** 2)
    u_t = tmgd.fill_u_from_map(ts, torchhp.InterpTables(order),
                               torch.tensor(potmap))
    u_j = jmgd.fill_u_from_map(js, jaxhp.InterpTables(order, jnp.float64),
                               jnp.asarray(potmap))
    close(u_t, u_j, "fill_u_from_map")
    # a rough patch field, and rays near their pixel centres
    u = np.asarray(u_j) + 0.1 * rng.normal(size=u_j.shape)
    npix = int(hp.order2npix(ray_order))
    nest = rng.permutation(npix)[: npix // 2]
    vec = hp.pix2vec_nest(nest, ray_order) + 0.01 * rng.normal(
        size=(len(nest), 3))
    vec *= 300.0
    cell = nest >> (2 * (ray_order - bundle_order))
    pot, grad, hess = jmgd.interp_derivs_to_rays(
        js, jnp.asarray(u), jnp.asarray(vec), jnp.asarray(cell))
    got = tmgd.interp_derivs_to_rays(ts, torch.tensor(u),
                                     torch.tensor(vec.T.copy()),
                                     torch.tensor(cell))
    close(got[0], pot, "pot")
    close(torch.stack(got[1:3], -1), grad, "grad")
    close(torch.stack(got[3:7], -1).reshape(-1, 2, 2), hess, "hess")
    # full-sky cells from RING storage order (taken on the device)
    ring = np.arange(npix)
    np.testing.assert_array_equal(
        tmgd.ray_cells(None, 0, npix, ray_order, bundle_order, "cpu").numpy(),
        hp.ring2nest(ring, ray_order) >> (2 * (ray_order - bundle_order)))


def _pointmass_cfg(tmp_path, variant):
    extra = {"fixed": {},
             "adaptive_sph": dict(MGConvFact=0.1, DepositScheme="SPH",
                                  ComvSmoothingScale=5.0),
             # a box around the mass: the rays carry their NEST pixels,
             # the SHT density its vacuum mask
             "box_cic": dict(DepositScheme="CIC", minRa=0.0, maxRa=70.0,
                             minDec=-20.0, maxDec=50.0)}[variant]
    return RayTraceConfig(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        LensPlanePath=str(tmp_path), LensPlaneName="pmplane",
        SHTOrder=4, rayOrder=5, bundleOrder=2,
        partMass=5.0e16, raPointMass=32.0, decPointMass=14.0,
        radPointMass=625.0, PointMassTest=True, Precision="f64",
        SHTOnly=False, **extra).finalize()


@pytest.mark.parametrize("variant", ["fixed", "adaptive_sph", "box_cic"])
def test_pointmass_mg_trace_matches_jax(tmp_path, variant):
    """Raytracer.step with SHTOnly = 0 on the point-mass planes (full sky
    with fixed cycles, MGConvFact with SPH, CIC in a box): the port's
    packed rays after every plane within 1e-10 of each quantity's max of
    the JAX package's, and tests/test_mg.py's
    physics bounds at the mass plane (median relative deflection error
    < 2 %, median cosine to the mass > 0.99)."""
    from calclens_tpu.driver import Raytracer as JRaytracer
    from calclens_tpu.driver import plane_params
    from calclens_tpu.testing import pointmass as pm
    from calclens_tpu_torch.driver import Raytracer as TRaytracer

    cfg = _pointmass_cfg(tmp_path, variant)
    mass_vec, mass_plane = pm.make_pointmass_planes(cfg)
    rj, rt = JRaytracer(cfg), TRaytracer(cfg, device="cpu")
    rj.mgsetup, rt.mgsetup = _setups(cfg.bundleOrder, 32, cfg.rayOrder)
    if variant == "adaptive_sph":
        rj.mgsetup.sph_sigmas = rj.sph[:-3]
        rt.mgsetup.sph_sigmas = rt.sph[:-3]
    # the JAX full-sky init_rays starts an f64 trace from float32 pixel
    # centres (tests/test_torch_maps.py): start it from the port's state
    rt.init_rays()
    rj.init_rays()
    if variant != "box_cic":
        rj.rays_packed = jnp.asarray(rt.rays_packed.numpy())
    for p in range(mass_plane + 1):
        rj.step(p)
        rt.step(p)
        got = rt.rays_packed.numpy()
        ref = np.asarray(rj.rays_packed)
        for lo, hi, what in ((0, 3, "n"), (3, 6, "beta"), (6, 10, "A"),
                             (10, 14, "Aprev"), (14, 16, "alpha"),
                             (16, 20, "U"), (20, 21, "phi")):
            close(got[lo:hi], ref[lo:hi], f"plane {p} {what}")
    if variant == "fixed":
        assert set(rt.mg_cycles.values()) == {10}
    # the same rays (rt.ray_nest sets the full sky's NEST table: read last)
    np.testing.assert_array_equal(rt.ray_nest, rj.ray_nest)

    alpha = rt.rays_packed[14:16].numpy().T
    n = rt.rays_packed[0:3].numpy().T
    nhat = n / np.linalg.norm(n, axis=1, keepdims=True)
    gamma = np.arccos(np.clip(nhat @ np.asarray(mass_vec), -1, 1))
    pp = plane_params(cfg, rj.cosmo, mass_plane)
    q = pm.charge(cfg, rj.cosmo, pp.rad)
    amag = np.hypot(alpha[:, 0], alpha[:, 1])
    sel = (gamma > 0.08) & (gamma < 0.25)
    ref = pm.alpha_exact(gamma[sel], q)
    assert np.median(np.abs(amag[sel] - ref) / ref) < 0.02
    phihat = np.stack([-nhat[:, 1], nhat[:, 0], np.zeros(len(nhat))], 1)
    phihat /= np.linalg.norm(phihat, axis=1, keepdims=True)
    thetahat = np.cross(phihat, nhat)
    avec = alpha[:, :1] * thetahat + alpha[:, 1:2] * phihat
    mv = np.asarray(mass_vec)
    tomass = mv[None, :] - nhat * (nhat @ mv)[:, None]
    tomass /= np.linalg.norm(tomass, axis=1, keepdims=True)
    cosang = (np.sum(avec[sel] * tomass[sel], 1)
              / np.linalg.norm(avec[sel], axis=1))
    assert np.median(cosang) > 0.99


def test_mg_refine_makes_no_host_copy_after_its_first_plane(monkeypatch):
    """The patch tables (rotations, neighbours, level rows, stamps, sigma
    buckets) are copied to the device once per MGSetup: a second plane's
    mg_refine and ray fields create no tensor from host data, so on a GPU
    they queue without waiting for the device (the adaptive solve's
    stopping test is the step's one host sync)."""
    _, ts = _setups(1, 8, 3)
    rng = np.random.default_rng(3)
    order = 3
    ts.sph_sigmas = (0.01, 0.05, 0.3)
    potmap = torch.tensor(rng.normal(size=int(hp.order2npix(order))))
    pos = torch.tensor(_unit_vectors(rng, 200) * 400.0)
    mass = torch.tensor(rng.uniform(1.0, 2.0, 200) * 1e12)
    sl = torch.tensor(rng.uniform(0.01, 0.3, 200))
    rows = torch.tensor(_unit_vectors(rng, 768).T * 500.0)
    nest = torch.tensor(rng.permutation(768))
    tab = torchhp.InterpTables(order)

    def plane():
        for conv, s in ((-1.0, None), (0.1, sl)):
            field, _ = tmgd.mg_refine(ts, tab, lambda a, b: rows[:, a:b],
                                      nest, 3, potmap, pos, mass, 1e-13, 0.1,
                                      conv_fact=conv, sl=s)
            field(0, 768)

    plane()

    def no_host_data(fn):
        def spy(data, *a, **k):
            assert not isinstance(data, (np.ndarray, list, tuple)), data
            return fn(data, *a, **k)
        return spy

    monkeypatch.setattr(torch, "as_tensor", no_host_data(torch.as_tensor))
    monkeypatch.setattr(torch, "tensor", no_host_data(torch.tensor))
    plane()


def _unit_vectors(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)
