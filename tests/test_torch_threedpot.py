"""The port's THREEDPOT path (calclens_tpu_torch/fftpot.py, io/lgadget.py
and the driver's ThreeDPot branch) against the JAX package's on the same
numpy inputs, on the CPU.

Tolerances, relative to each quantity's max |value| over the compared set:
- 1e-12 where both sides round alike: the CIC deposit (float32 counts,
  added in one order), the Poisson kernel, the path sampling on a shared
  grid;
- POT_BOUND (2e-6) for the potential grid: the JAX function takes its
  forward transform of the float32 counts in complex64 even under x64,
  and XLA's FFT and torch's (MKL here, cuFFT on the card) round it apart
  by ~1e-7 of max;
- TRACE_BOUND (1e-10) for the driver's float64 trace from one grid, and
  OWN_GRID_BOUND (1e-5) for the trace where each package builds its own
  grid (the grids' float32 roundings above, carried through four planes);
- the JAX tests' own bounds for the physics checks.
"""
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from calclens_tpu import config as jconfig
from calclens_tpu import fftpot as jf
from calclens_tpu.cosmology import Cosmology as JCosmology, RHO_CRIT, CSOL
from calclens_tpu.driver import Raytracer as JRaytracer
from calclens_tpu.io import lgadget as jlg
from calclens_tpu.rays.propagate import init_rays as jinit_rays
from calclens_tpu_torch import fftpot as tf
from calclens_tpu_torch import config as tconfig
from calclens_tpu_torch.cosmology import Cosmology as TCosmology
from calclens_tpu_torch.driver import Raytracer as TRaytracer
from calclens_tpu_torch.rays import soa
from calclens_tpu_torch.rays.propagate import Rays as TRays

EXACT = 1e-12
POT_BOUND = 2e-6
TRACE_BOUND = 1e-10
OWN_GRID_BOUND = 1e-5
G = jf.FOUR_PI_G / (4.0 * np.pi)  # Mpc (km/s)^2 / Msun


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread (the suite runs six
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-300)


def _write_snap(path, pos, L=200.0, time=1.0, mass=None, **kw):
    jlg.write_snapshot(str(path), pos, mass1_1e10=(
        mass if mass is not None else RHO_CRIT * 0.3 * L ** 3 / 1e10 / len(pos)),
        time=time, boxsize=L, **kw)


def test_snapshot_list_and_grid_size_match_jax(tmp_path):
    """read_snap_list (a one-file snapshot, a two-file group named by its
    basename, comments), nearest_snap, choose_nfft and the files of each
    snapshot."""
    rng = np.random.default_rng(1)
    _write_snap(tmp_path / "a", rng.uniform(0, 200, (10, 3)), time=0.8)
    for i in range(2):
        _write_snap(tmp_path / f"b.{i}", rng.uniform(0, 500, (7, 3)),
                    L=500.0, time=0.5, num_files=2, npart_total=14)
    lst = tmp_path / "snaps.txt"
    lst.write_text(f"# snapshots\n{tmp_path / 'a'}\n\n{tmp_path / 'b'}\n")
    for lc in (1.0, 1e-3):
        ref = jf.read_snap_list(str(lst), JCosmology(0.3), lc)
        got = tf.read_snap_list(str(lst), TCosmology(0.3), lc)
        assert got == ref and len(got) == 2
    for rad in (0.0, 500.0, 1200.0, 1300.0, 5000.0):
        assert tf.nearest_snap(got, rad) == jf.nearest_snap(ref, rad)
    assert tf.snapshot_files(str(tmp_path / "a")) == [str(tmp_path / "a")]
    assert tf.snapshot_files(str(tmp_path / "b")) == [
        str(tmp_path / "b.0"), str(tmp_path / "b.1")]
    for L in (200.0, 1050.0, 3000.0):
        for rad in (12.5, 100.0, 200.0, 987.5):
            for min_sl in (0.01, 0.003):
                for mx in (-1, 256):
                    assert tf.choose_nfft(L, rad, min_sl, mx) == \
                        jf.choose_nfft(L, rad, min_sl, mx)
    # the smoke's design point: 1024 at 200 Mpc/h in a 1050 Mpc/h box
    assert tf.choose_nfft(1050.0, 200.0, 0.01) == 1024


@pytest.mark.parametrize("nfft", [32, 64])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cic_deposit_matches_jax(nfft, dtype):
    """Positions inside and outside [0, L) (negative too) deposit the same
    float32 counts; the total is the particle count."""
    rng = np.random.default_rng(nfft)
    L = 200.0
    pos = rng.uniform(-60.0, 260.0, (4000, 3)).astype(dtype)
    ref = np.asarray(jf.cic_deposit_3d(jnp.asarray(pos), nfft,
                                       jnp.asarray(L, dtype)))
    got = tf.cic_deposit_3d(torch.from_numpy(pos), nfft, L)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert rel(got, ref) < EXACT
    assert abs(float(got.double().sum()) - len(pos)) < 1e-3


@partial(jax.jit, static_argnums=(0,))
def _jax_kernel_and_solve(nfft, rho, L, a, mp):
    """JAX's kernel at potential_from_counts' wave vectors and scalars
    (float64 k, float32 dL and potfact), and jnp.fft's solve of float64
    counts with it."""
    dL = jnp.float32(L) / nfft
    potfact = jf.FOUR_PI_G / jnp.float32(a) * jnp.float32(mp) / (dL * dL * dL)
    kfull = 2.0 * jnp.pi * jnp.fft.fftfreq(nfft) / dL * 1.0
    khalf = 2.0 * jnp.pi * jnp.fft.rfftfreq(nfft) / dL
    kern = jf._poisson_kern(kfull[:, None, None], kfull[None, :, None],
                            khalf[None, None, :], dL, potfact)
    pot = jnp.fft.irfftn(jnp.fft.rfftn(rho) * kern, s=(nfft,) * 3)
    return dL, potfact, kfull, khalf, kern, pot


@pytest.mark.parametrize("nfft", [32, 64])
def test_poisson_kernel_and_float64_solve_match_jax(nfft):
    """_poisson_kern at the JAX function's float64 wave vectors and float32
    dL, potfact; and the port's solve with the float64 kernel on float64
    counts (solve_potential) against jnp.fft with JAX's kernel."""
    L, a, mp = 200.0, 0.8, 3.0e11
    rho = np.random.default_rng(nfft).uniform(0.0, 3.0, (nfft,) * 3)
    dL, potfact, kfull, khalf, ref, ref_pot = _jax_kernel_and_solve(
        nfft, jnp.asarray(rho), L, a, mp)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    kf, kh = t(kfull), t(khalf)
    got = tf._poisson_kern(kf[:, None, None], kf[None, :, None],
                           kh[None, None, :], t(dL), t(potfact))
    assert got.dtype == torch.float64 and t(dL).dtype == torch.float32
    assert rel(got, ref) < EXACT
    got_pot = tf.solve_potential(torch.from_numpy(rho), nfft, L, a, mp)
    assert got_pot.dtype == torch.float64
    assert rel(got_pot, ref_pot) < EXACT


@pytest.mark.parametrize("nfft", [32, 64])
@pytest.mark.parametrize("field", ["blob", "uniform"])
def test_potential_from_counts_matches_jax(nfft, field):
    """The float32 potential grid from the same counts (a Gaussian blob,
    or uniform particles: nearly all of the power in the zero mode the
    kernel nulls) against JAX's under x64: POT_BOUND."""
    rng = np.random.default_rng(10 + nfft)
    pos = (np.mod(100.0 + rng.normal(scale=20.0, size=(20000, 3)), 200.0)
           if field == "blob" else rng.uniform(0.0, 200.0, (20000, 3)))
    counts = np.asarray(jf.cic_deposit_3d(jnp.asarray(pos, jnp.float32),
                                          nfft, jnp.float32(200.0)))
    ref = np.asarray(jf.potential_from_counts(
        jnp.asarray(counts), nfft, jnp.float32(200.0), jnp.float32(0.8),
        jnp.float32(3e11)))
    got = tf.potential_from_counts(torch.from_numpy(counts.copy()), nfft,
                                   200.0, 0.8, 3e11)
    assert got.dtype == torch.float32 and got.shape == (nfft,) * 3
    assert rel(got, ref) < POT_BOUND


def test_trilinear_matches_jax():
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(16, 16, 16)).astype(np.float32)
    u = rng.uniform(-3.0, 19.0, (50, 7, 3))
    ref = jf._trilinear(jnp.asarray(grid), jnp.asarray(u))
    got = tf._trilinear(torch.from_numpy(grid), torch.from_numpy(u))
    assert rel(got, ref) < EXACT


def _grid(nfft, seed=5):
    """A float32 potential grid with structure on the cell scale."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(0.0, 200.0, (3000, 3)),
                          np.mod(rng.normal(60.0, 4.0, (3000, 3)), 200.0)])
    return np.array(jf.compute_potential_grid(pos, 200.0, nfft, 0.9, 0.3,
                                              len(pos)))


def _rays(n, seed, dtype, rad=300.0):
    """Random directions plus the poles and rays near them, with nonzero
    alpha, U and phi rows (the step adds to them)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v[:4] = [[0, 0, 1], [0, 0, -1], [1e-4, 0, 1], [0, -2e-4, -1]]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = jinit_rays(jnp.asarray(v, dtype), rad, dtype=dtype)
    return r._replace(alpha=jnp.asarray(rng.normal(size=(n, 2)), dtype),
                      U=jnp.asarray(rng.normal(size=(n, 2, 2)), dtype),
                      phi=jnp.asarray(rng.normal(size=n), dtype))


@pytest.mark.parametrize("view", ["rays", "packed"])
@pytest.mark.parametrize("dtype,bound", [(np.float64, EXACT),
                                         (np.float32, 2e-5)])
def test_apply_to_rays_matches_jax(view, dtype, bound, monkeypatch):
    """threedpot_apply_to_rays on the Rays view and threedpot_rows on the
    packed buffer (in sample chunks of 999, so chunk edges fall inside
    rays) against JAX's on the same float32 grid.  float32: 2e-5 of max (the
    ten fields' sums over 40 samples in another order, and arccos, atan2,
    sin and cos of XLA and of torch)."""
    nfft, nint = 32, 40
    grid = _grid(nfft)
    rays = _rays(300, 7, dtype)
    ref = jf.threedpot_apply_to_rays(
        rays, jnp.asarray(grid), nfft, nint, jnp.asarray(200.0, dtype),
        jnp.asarray(300.0, dtype), jnp.asarray(50.0, dtype))
    trays = TRays(*(torch.from_numpy(np.array(x)) for x in rays))
    if view == "rays":
        got = tf.threedpot_apply_to_rays(trays, torch.from_numpy(grid), nfft,
                                         nint, 200.0, 300.0, 50.0)
    else:
        monkeypatch.setattr(tf, "SAMPLES_PER_CHUNK", 999)

        def s(x):
            return torch.tensor(x, dtype=trays.n.dtype)

        packed = soa.pack(trays)
        out = tf.threedpot_rows(packed, tf.pad_periodic(
            torch.from_numpy(grid)), nfft, nint, s(200.0), s(300.0), s(50.0))
        assert torch.equal(out[:14], packed[:14])
        got = soa.unpack(out)
    for key in ("alpha", "U", "phi"):
        g = getattr(got, key)
        assert g.dtype == trays.n.dtype
        assert rel(g, getattr(ref, key)) < bound, key


def test_float32_polar_rays_no_farther_from_float64_than_jax():
    """theta = arccos(clip(z)) as the JAX package takes it: the float32
    fields of rays at and near the poles lie no farther from a float64
    evaluation than JAX's float32 fields do (factor 2)."""
    nfft, nint = 32, 40
    grid = _grid(nfft, seed=6)
    args = (nfft, nint)
    out = {}
    for dtype in (np.float64, np.float32):
        rays = _rays(300, 8, dtype)  # the shapes above: no new JAX compile
        jr = jf.threedpot_apply_to_rays(
            rays, jnp.asarray(grid), *args, jnp.asarray(200.0, dtype),
            jnp.asarray(300.0, dtype), jnp.asarray(50.0, dtype))
        tr = tf.threedpot_apply_to_rays(
            TRays(*(torch.from_numpy(np.array(x)) for x in rays)),
            torch.from_numpy(grid), *args, 200.0, 300.0, 50.0)
        out[dtype] = (jr, tr)
    for key in ("alpha", "U"):
        ref = np.asarray(getattr(out[np.float64][0], key))[:4]
        scale = np.max(np.abs(np.asarray(getattr(out[np.float64][0], key))))
        d_jax = np.max(np.abs(np.asarray(getattr(out[np.float32][0], key))[:4]
                              - ref)) / scale
        d_port = np.max(np.abs(getattr(out[np.float32][1], key).numpy()[:4]
                               - ref)) / scale
        assert d_port <= 2.0 * d_jax + 1e-6, (key, d_port, d_jax)


def _trace_cfg(mod, snaplist, **kw):
    return mod.RayTraceConfig(
        OmegaM=0.3, maxComvDistance=1000.0, NumLensPlanes=4,
        rayOrder=4, bundleOrder=2, SHTOrder=4,
        ThreeDPot=True, ThreeDPotSnapList=str(snaplist), NFFT=32,
        Precision="f64", **kw).finalize()


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    """JAX's test_threedpot_driver_end_to_end configuration: one particle
    of the box's mass at (100, 100, 100) in L = 200, NFFT 32, rayOrder 4,
    4 planes, float64.  Returns the snapshot list, the initial packed rays,
    the packed rays after every plane and JAX's grid."""
    tmp = tmp_path_factory.mktemp("threedpot")
    snap = tmp / "snap_000"
    _write_snap(snap, np.array([[100.0, 100.0, 100.0]]))
    lst = tmp / "snaps.txt"
    lst.write_text(f"{snap}\n")
    rt = JRaytracer(_trace_cfg(jconfig, lst))
    rt.init_rays()
    init = np.array(rt.rays_packed)
    planes = []
    for p in range(4):
        rt.step(p)
        planes.append(np.array(rt.rays_packed))
    return lst, init, planes, np.array(rt.threedpot._cached[2])


@pytest.mark.parametrize("shared", [True, False])
def test_threedpot_trace_matches_jax(jax_trace, shared):
    """The port's Raytracer (CPU, float64) from JAX's initial rays, four
    planes through step(): with JAX's grid given to its driver, within
    TRACE_BOUND of each quantity's max after every plane; with its own
    grid, within OWN_GRID_BOUND."""
    lst, init, planes, jgrid = jax_trace
    rt = TRaytracer(_trace_cfg(tconfig, lst), device="cpu")
    rt.load_state(init, 0)
    if shared:
        g = torch.from_numpy(jgrid)
        d = rt._threedpot()
        d._cached = (0, 32, g, 200.0, tf.pad_periodic(g))
    bound = TRACE_BOUND if shared else OWN_GRID_BOUND
    for p in range(4):
        rt.step(p)
        got = rt.rays_packed.numpy()
        for lo, hi in ((0, 3), (3, 6), (6, 14), (14, 16), (16, 20), (20, 21)):
            err = rel(got[lo:hi], planes[p][lo:hi])
            assert err < bound, (p, lo, hi, err)
    assert rt.threedpot.builds == (0 if shared else 1)
    if not shared:
        assert rel(rt.threedpot._cached[2], jgrid) < POT_BOUND


def test_potential_gaussian_blob_through_port():
    """JAX's test_potential_gaussian_blob through the port: a resolved
    Gaussian blob's exterior potential follows -GM/r within 0.1."""
    L, nfft = 200.0, 64
    dL = L / nfft
    rng = np.random.default_rng(0)
    n = 200000
    c = L / 2.0
    pos = np.mod(c + rng.normal(scale=2.5 * dL, size=(n, 3)), L)
    grid = tf.compute_potential_grid(pos, L, nfft, 1.0, 0.3, n).numpy()
    M = RHO_CRIT * 0.3 * L ** 3
    i0 = int(c / dL)
    dis = (6, 8, 10, 13)
    got = np.array([grid[(i0 + di) % nfft, i0, i0] for di in dis])
    r = np.array([(di + 0.5 - (c / dL - i0)) for di in dis]) * dL
    want = -G * M / r
    dgot = got[:-1] - got[-1]
    dwant = want[:-1] - want[-1]
    err = np.abs(dgot - dwant) / np.abs(dwant)
    assert np.max(err) < 0.1, (dgot, dwant, err)


def test_ray_deflection_toward_point_mass_through_port():
    """JAX's test_ray_deflection_toward_point_mass through the port: the
    truncated thin-lens deflection within 0.2 (median), pointing at the
    mass (cos > 0.97), finite U."""
    L, nfft = 200.0, 64
    binL = 250.0
    mp = RHO_CRIT * 0.3 * L ** 3
    grid = tf.compute_potential_grid(np.array([[100.0, 100.0, 100.0]]), L,
                                     nfft, 1.0, 0.3, 1)
    pvec = np.array([500.0, 300.0, 300.0])
    prad = np.linalg.norm(pvec)
    phat = pvec / prad
    e1 = np.cross(phat, [0, 0, 1.0])
    e1 /= np.linalg.norm(e1)
    bs = np.array([10.0, 15.0, 20.0, 30.0])
    nhat = phat[None, :] + (bs / prad)[:, None] * e1[None, :]
    nhat /= np.linalg.norm(nhat, axis=1, keepdims=True)
    n = len(nhat)
    eye = torch.eye(2, dtype=torch.float64).expand(n, 2, 2)
    rays = TRays(n=torch.from_numpy(nhat * prad), beta=torch.from_numpy(nhat),
                 A=eye, Aprev=eye, alpha=torch.zeros(n, 2, dtype=torch.float64),
                 U=torch.zeros(n, 2, 2, dtype=torch.float64),
                 phi=torch.zeros(n, dtype=torch.float64))
    nint = int(binL / (L / nfft) * 2)
    out = tf.threedpot_apply_to_rays(rays, grid.double(), nfft, nint, L,
                                     prad, binL)
    alpha = out.alpha.numpy()
    amag = np.hypot(alpha[:, 0], alpha[:, 1])
    x = binL / 2.0 / bs
    want = 4.0 * G * mp / CSOL ** 2 / bs * (x / np.sqrt(1.0 + x * x))
    assert np.median(np.abs(amag - want) / want) < 0.2, (amag, want)
    gvec = phat - nhat * (nhat @ phat)[:, None]
    gvec /= np.linalg.norm(gvec, axis=1, keepdims=True)
    phihat = np.stack([-nhat[:, 1], nhat[:, 0], np.zeros(n)], 1)
    phihat /= np.linalg.norm(phihat, axis=1, keepdims=True)
    thetahat = np.cross(phihat, nhat)
    avec = alpha[:, :1] * thetahat + alpha[:, 1:2] * phihat
    cosang = np.sum(avec * gvec, 1) / np.linalg.norm(avec, axis=1)
    assert np.all(cosang > 0.97)
    assert np.all(np.isfinite(out.U.numpy()))


def test_threedpot_run_restart_and_cli(jax_trace, tmp_path):
    """JAX's end-to-end checks through the port's run() (radii 1000 within
    1e-9, finite A, nonzero convergence), with Profile's timing.0 columns;
    a run stopped after two planes and resumed from its restart, and the
    CLI, end on the same rays."""
    from calclens_tpu_torch import raytrace

    lst = jax_trace[0]
    out = tmp_path / "full"
    out.mkdir()
    rt = TRaytracer(_trace_cfg(tconfig, lst, OutputPath=str(out),
                               Profile=True), device="cpu")
    rt.run(progress=False)
    n = rt.rays_packed[0:3].numpy()
    np.testing.assert_allclose(np.linalg.norm(n, axis=0), 1000.0, rtol=1e-9)
    A = rt.rays_packed[6:10].numpy()
    assert np.all(np.isfinite(A))
    assert np.max(np.abs(1 - 0.5 * (A[0] + A[3]))) > 0
    rows = (out / "timing.0").read_text().splitlines()
    head = rows[0].split()
    assert len(rows) == 5 and head[3:6] == ["Deposit", "Shtsolve", "Sht"]
    first = dict(zip(head[1:], map(float, rows[1].split())))
    assert first["Deposit"] > 0 and first["Partio"] > 0 and first["Rayprop"] > 0
    assert rt.threedpot.builds == 1

    part = tmp_path / "part"
    part.mkdir()
    rs = TRaytracer(_trace_cfg(tconfig, lst, OutputPath=str(part)),
                    device="cpu")
    rs.init_rays()
    for p in range(2):
        rs.step(p)
    rs.save_restart()
    cfg_file = tmp_path / "three.cfg"
    cfg_file.write_text(_trace_cfg(tconfig, lst, OutputPath=str(part))
                        .to_cfg())
    assert raytrace.main([str(cfg_file), "--device", "cpu"]) == 0
    ru = TRaytracer(_trace_cfg(tconfig, lst, OutputPath=str(part)),
                    device="cpu")
    ru.load_restart()
    assert ru.current_plane == 4
    torch.testing.assert_close(ru.rays_packed, rt.rays_packed, rtol=0,
                               atol=0)


def test_snapranges_cli_matches_jax(tmp_path, capsys):
    """python -m calclens_tpu_torch.fftpot <cfg> (snapranges_main) prints
    JAX's table for a two-snapshot list."""
    cosmo = JCosmology(0.3)
    for name, chi in (("near", 300.0), ("far", 900.0)):
        _write_snap(tmp_path / name, np.zeros((2, 3)),
                    time=float(cosmo.acomvdist(chi)))
    lst = tmp_path / "snaps.txt"
    lst.write_text(f"{tmp_path / 'near'}\n{tmp_path / 'far'}\n")
    cfg = tmp_path / "s.cfg"
    cfg.write_text(f"OmegaM 0.3\nmaxComvDistance 1200\nNumLensPlanes 6\n"
                   f"ThreeDPot 1\nThreeDPotSnapList {lst}\n")
    assert jf.snapranges_main([str(cfg)]) == 0
    ref = capsys.readouterr().out
    assert tf.snapranges_main([str(cfg)]) == 0
    got = capsys.readouterr().out
    assert got == ref and "near" in got and "far" in got
    assert len(got.splitlines()) == 7


def test_two_file_snapshot_port_deposits_every_file(tmp_path):
    """A snapshot written as .0 and .1 (num_files 2): the port's grid is
    the grid of all its particles (JAX's one-file grid of the same
    particles, POT_BOUND); the JAX driver deposits .0 alone, each particle
    still of the mass of one in npart_total (ROADMAP Queue 3)."""
    rng = np.random.default_rng(4)
    pos = np.concatenate([np.mod(rng.normal(50.0, 6.0, (3000, 3)), 200.0),
                          np.mod(rng.normal(150.0, 6.0, (3000, 3)), 200.0)])
    n = len(pos)
    mass = RHO_CRIT * 0.3 * 200.0 ** 3 / 1e10 / n
    _write_snap(tmp_path / "one", pos, mass=mass)
    for i, part in enumerate((pos[: n // 2], pos[n // 2:])):
        _write_snap(tmp_path / f"two.{i}", part, mass=mass, num_files=2,
                    npart_total=n)
    grids = {}
    for name in ("one", "two"):
        lst = tmp_path / f"{name}.txt"
        lst.write_text(f"{tmp_path / name}\n")
        cfg = dict(ThreeDPot=True, ThreeDPotSnapList=str(lst), NFFT=32,
                   OmegaM=0.3, maxComvDistance=1000.0, NumLensPlanes=4)
        jd = jf.ThreeDPotDriver(jconfig.RayTraceConfig(**cfg).finalize(),
                                JCosmology(0.3))
        td = tf.ThreeDPotDriver(tconfig.RayTraceConfig(**cfg).finalize(),
                                TCosmology(0.3), "cpu")
        grids[name] = (np.asarray(jd.grid_for_plane(100.0, 0.01)[0]),
                       td.grid_for_plane(100.0, 0.01)[0])
    jone, tone = grids["one"]
    jtwo, ttwo = grids["two"]
    assert rel(tone, jone) < POT_BOUND
    assert rel(ttwo, jone) < POT_BOUND
    assert rel(jtwo, jone) > 0.1
    half = np.asarray(jf.compute_potential_grid(pos[: n // 2], 200.0, 32,
                                                1.0, 0.3, n))
    assert rel(jtwo, half) < EXACT
