"""The port's multigrid step, its slab-decomposed THREEDPOT solve and
Raytracer(mesh=) for SHTOnly 0 and ThreeDPot, on a mesh of ranks
(torch.distributed, gloo, CPU), against the JAX package's sharded path on
its virtual CPU devices (tests/conftest.py) and the port's one-device path.

One spawn of 4 ranks (parallel.launch.run_ranks, a FileStore under the
test's tmp dir, its own timeout) runs every rank case, each rank on one
torch thread.  The pairs (0, 1) and (2, 3) first run the 2-rank cases on a
group each, then all four the 4-rank cases.  The ranks import neither jax
nor calclens_tpu; this module imports them inside the tests only.

- The slab Poisson solve at nfft 32 (JAX's tests/test_slabfft.py inputs) on
  2 and 4 ranks: each rank holds its x rows only; against JAX's
  potential_from_counts_slab on a 2- and a 4-device mesh within SLAB_BOUND
  (both solve in complex64; XLA's FFT and torch's round apart) and JAX's
  one-device potential_from_counts within JAX's own 2e-5 of the max.
- The multigrid step in float64 on JAX's point-mass configuration
  (tests/test_mg_sharded.py: SHTOrder 5, rayOrder 6, bundleOrder 2, so
  C = 192 patches; both packages' patch tables preset at interior
  MG_N = 16, as tests/test_torch_mg.py presets them, for the file's CPU
  budget), the mass plane stepped from the
  port's initial rays: NGP on 2 ranks against JAX's step on its 2-device
  mesh at JAX's rtol 1e-10 / atol 1e-12 (test_mg_sharded.py:48); NGP, and
  SPH with MGConvFact 0.1, on 2 and 4 ranks, and a CIC box on 2, against
  the port's one-device step at the same bound, every rank taking the
  one-device V-cycle count.  The other JAX sharded steps are left out for
  the file's CPU budget: tests/test_torch_mg.py holds the one-device step
  to JAX's, tests/test_mg_sharded.py JAX's sharded step to its one-device
  step.
- THREEDPOT on 2 ranks (one file each) and 4 ranks (each a block of both
  files' rows), the two-file snapshot of tests/test_torch_threedpot.py,
  NFFT 32, rayOrder 3, Raytracer.run over 2 planes in float64 with lens
  maps and ray files: against the port's one-device run within
  TDP_BOUND of each quantity's max (the slab solve runs in complex64, the
  one-device solve's inverse in complex128: the float32 grids round apart
  by ~1e-7); the ranks' particles sum to the snapshot's; one grid build;
  rank 0 writes the files one device writes.
"""
import os
import sys

import numpy as np
import pytest
import torch

from calclens_tpu_torch.config import RayTraceConfig
from calclens_tpu_torch.parallel.launch import run_ranks

# the JAX tests' bounds: test_mg_sharded.py:48, test_slabfft.py
MG_RTOL, MG_ATOL = 1e-10, 1e-12
SLAB_ONE_DEVICE = 2e-5
# the slab solve against JAX's slab solve (both complex64), relative to
# the max: XLA's and torch's FFTs round the float32 transforms apart
SLAB_BOUND = 2e-6
# THREEDPOT on a mesh against one device, each quantity's max: the float32
# grid of a complex64 solve against one of a complex128 inverse
TDP_BOUND = 1e-5
NFFT = 32
SLAB_INPUT = dict(L=100.0, a=0.8, mp=1.0e10)
MG_CASES = {"NGP": {},
            "SPH conv": dict(MGConvFact=0.1, DepositScheme="SPH",
                             ComvSmoothingScale=5.0),
            "CIC box": dict(DepositScheme="CIC", minRa=0.0, maxRa=70.0,
                            minDec=-20.0, maxDec=50.0)}
TDP_PLANES = 2
# the preset patch interior of both packages' MG steps
MG_N = 16
# the packed rows of each quantity: n, beta, A, Aprev, alpha, U, phi
GROUPS = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))


def slab_counts():
    """JAX's tests/test_slabfft.py counts grid."""
    rng = np.random.default_rng(0)
    return rng.poisson(2.0, (NFFT,) * 3).astype(np.float32)


def mg_cfg(tmp, config=RayTraceConfig, **kw):
    """JAX's point-mass configuration (tests/test_mg_sharded.py), as the
    port's RayTraceConfig or `config`."""
    return config(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        LensPlanePath=os.path.join(tmp, "pm"), LensPlaneName="pmplane",
        SHTOrder=5, rayOrder=6, bundleOrder=2,
        partMass=5.0e16, raPointMass=32.0, decPointMass=14.0,
        radPointMass=625.0, PointMassTest=True, Precision="f64",
        SHTOnly=False, **kw).finalize()


def tdp_cfg(tmp, out):
    """THREEDPOT over TDP_PLANES planes with lens maps after each and two
    ray files, written into <tmp>/<out>."""
    return RayTraceConfig(
        OmegaM=0.3, maxComvDistance=1000.0, NumLensPlanes=TDP_PLANES,
        rayOrder=3, bundleOrder=2, SHTOrder=4, ThreeDPot=True,
        ThreeDPotSnapList=os.path.join(tmp, "two.txt"), NFFT=NFFT,
        Precision="f64", MapRedshiftList=os.path.join(tmp, "zs"),
        LensMapOrder=2, RayOutputName="rays_", NumRayOutputFiles=2,
        OutputPath=os.path.join(tmp, out)).finalize()


MASS_PLANE = 2  # radPointMass 625 in planes of 250 Mpc/h


def mg_plane(mesh, tmp, label):
    """The port's multigrid step of the mass plane from its initial rays
    (on `mesh`, or one device when None): (the whole packed buffer, the
    V-cycles of the patch solve)."""
    from calclens_tpu_torch import mgdriver
    from calclens_tpu_torch.driver import Raytracer

    rt = Raytracer(mg_cfg(tmp, **MG_CASES[label]), device="cpu", mesh=mesh)
    rt.mgsetup = mgdriver.MGSetup(2, MG_N, 6, dtype=torch.float64)
    if rt.sph is not None:
        rt.mgsetup.sph_sigmas = rt.sph[:-3]
    rt.init_rays()
    rt.step(MASS_PLANE)
    return rt.packed_global().numpy(), rt.mg_cycles[MASS_PLANE]


def threedpot(mesh, tmp):
    """Raytracer.run over the TDP_PLANES THREEDPOT planes (on `mesh`, or
    one device), into <tmp>/tdp<ranks>: the whole packed buffer, the grid
    builds, the particles this rank deposited, the float64 total of its
    reduce-scattered counts (on a mesh), the files this rank read and the
    files the run wrote."""
    from calclens_tpu_torch.driver import Raytracer

    n = 1 if mesh is None else mesh.size
    rt = Raytracer(tdp_cfg(tmp, f"tdp{n}"), device="cpu", mesh=mesh)
    totals = []
    if mesh is not None:
        keep = mesh.reduce_scatter_rows

        def counted(x):
            out = keep(x)
            totals.append(float(out.sum(dtype=torch.float64)))
            return out
        mesh.reduce_scatter_rows = counted
    rt.run(progress=False)
    if mesh is not None:
        del mesh.reduce_scatter_rows
        mesh.barrier()  # rank 0's files are written
    d = rt.threedpot
    return dict(packed=rt.packed_global().numpy(), builds=d.builds,
                rows=d.rows_deposited, totals=totals,
                files=d._my_files(d.snaps[0]["fname"]),
                written=sorted(os.listdir(os.path.join(tmp, f"tdp{n}"))))


def slab(mesh):
    """This rank's x rows of the slab solve of slab_counts()."""
    from calclens_tpu_torch import fftpot

    a, b = mesh.block(NFFT)
    counts = torch.from_numpy(slab_counts()[a:b].copy())
    out = fftpot.potential_from_counts_slab(counts, NFFT, **SLAB_INPUT,
                                            mesh=mesh)
    return (a, b), out.numpy()


def _pair_cases(mesh, which, tmp):
    if which == 0:
        out = {label: mg_plane(mesh, tmp, label)
               for label in ("NGP", "SPH conv")}
    else:
        out = {"CIC box": mg_plane(mesh, tmp, "CIC box"),
               "threedpot": threedpot(mesh, tmp), "slab": slab(mesh)}
    out["calls"] = dict(mesh.calls)
    return out


def _rank_cases(mesh, tmp):
    """Every case of this module on one rank of 4 (in the spawned ranks):
    the 2-rank cases on the pairs (0, 1) and (2, 3), each a Mesh over its
    own group, then the 4-rank cases."""
    import torch.distributed as dist

    from calclens_tpu_torch.parallel.sharding import Mesh

    assert "jax" not in sys.modules and "calclens_tpu" not in sys.modules
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    which = mesh.rank // 2
    out = {"two": _pair_cases(Mesh(mesh.device, pairs[which]), which, tmp)}
    mesh.barrier()
    out["four"] = {label: mg_plane(mesh, tmp, label)
                   for label in ("NGP", "SPH conv")}
    out["four"]["threedpot"] = threedpot(mesh, tmp)
    out["four"]["slab"] = slab(mesh)
    out["jax_loaded"] = "jax" in sys.modules or "calclens_tpu" in sys.modules
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This process's torch work (the one-device references) in one
    intra-op thread, as each rank's: the tensors are small, and under the
    suite's parallel workers torch's thread pools would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(tmp dir, the 4 ranks' results): the point-mass planes and the
    two-file snapshot are written, then the ranks run."""
    from calclens_tpu_torch.cosmology import RHO_CRIT
    from calclens_tpu_torch.io import lgadget
    from calclens_tpu_torch.testing import pointmass as pm

    tmp = tmp_path_factory.mktemp("mesh_mg")
    pm.make_pointmass_planes(mg_cfg(str(tmp)))
    # tests/test_torch_threedpot.py's two-file snapshot
    rng = np.random.default_rng(4)
    pos = np.concatenate([np.mod(rng.normal(50.0, 6.0, (3000, 3)), 200.0),
                          np.mod(rng.normal(150.0, 6.0, (3000, 3)), 200.0)])
    n = len(pos)
    for i, part in enumerate((pos[: n // 2], pos[n // 2:])):
        lgadget.write_snapshot(
            str(tmp / f"two.{i}"), part,
            mass1_1e10=RHO_CRIT * 0.3 * 200.0 ** 3 / 1e10 / n, time=1.0,
            boxsize=200.0, num_files=2, npart_total=n)
    (tmp / "two.txt").write_text(f"{tmp / 'two'}\n")
    (tmp / "zs").write_text("0.05\n0.15\n")  # maps after planes 0, 1
    ranks = run_ranks(_rank_cases, 4, str(tmp / "store"), device="cpu",
                      timeout=120.0, args=(str(tmp),))
    return str(tmp), ranks


@pytest.fixture(scope="module")
def one(runs):
    """The port's one-device results of the same cases."""
    tmp = runs[0]
    out = {label: mg_plane(None, tmp, label) for label in MG_CASES}
    out["threedpot"] = threedpot(None, tmp)
    return out


def _row_err(got, ref):
    """Max over the quantities of |got - ref| / max |ref|."""
    worst = 0.0
    for a, b in GROUPS:
        scale = np.abs(ref[a:b]).max() + 1e-300
        worst = max(worst, float(np.abs(got[a:b] - ref[a:b]).max() / scale))
    return worst


def _two(runs, key):
    """The 2-rank results of `key` on its pair of ranks."""
    ranks = [r["two"] for r in runs[1]]
    return [r[key] for r in ranks if key in r]


def _four(runs, key):
    return [r["four"][key] for r in runs[1]]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def test_ranks_import_no_jax_and_raytracer_runs_on_a_mesh(runs):
    """No rank imported jax or calclens_tpu; Raytracer(mesh=) built and
    stepped every SHTOnly 0 and ThreeDPot case of the ranks (the port
    refused both on a mesh before), and the steps' collectives ran: per MG
    step the map deposit's and the patch deposit's reduce-scatters, the
    potential map's and the solved patches' all-gathers; per grid build
    the counts' reduce-scatter, the slab solve's two all-to-alls and the
    grid's all-gather."""
    assert not any(r["jax_loaded"] for r in runs[1])
    calls = _two(runs, "calls")
    assert calls[0]["reduce_scatter"] >= 4 and calls[0]["all_gather"] >= 4
    assert calls[1]["all_to_all"] >= 2


# ---------------------------------------------------------------------------
# the slab Poisson solve
# ---------------------------------------------------------------------------

def _slab_whole(parts, n):
    """The ranks' x rows in rank order, each rank holding nfft / n."""
    assert len(parts) == n
    for r, ((a, b), x) in enumerate(parts):
        assert (a, b) == (r * NFFT // n, (r + 1) * NFFT // n)
        assert x.shape == (NFFT // n, NFFT, NFFT) and x.dtype == np.float32
    return np.concatenate([x for _, x in parts])


@pytest.mark.parametrize("n", [2, 4])
def test_slab_solve_matches_jax_slab_and_one_device_solve(runs, n):
    """Each of n ranks holds its nfft / n x rows of the potential; joined,
    they match JAX's slab solve on an n-device mesh within SLAB_BOUND and
    JAX's one-device solve within its own 2e-5 of the max."""
    import jax
    from jax.sharding import Mesh

    from calclens_tpu import fftpot as jf
    from calclens_tpu.parallel.sharding import AXIS

    got = _slab_whole(_two(runs, "slab") if n == 2 else _four(runs, "slab"),
                      n)
    counts = jax.numpy.asarray(slab_counts())
    mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))
    # one compiled program (called eagerly, its shard_map compiles each
    # operation apart: ~8 s of CPU per mesh)
    ref = np.asarray(jax.jit(jf.potential_from_counts_slab,
                             static_argnums=(1, 2, 3, 4, 5))(
        counts, NFFT, SLAB_INPUT["L"], SLAB_INPUT["a"], SLAB_INPUT["mp"],
        mesh))
    one = np.asarray(jf.potential_from_counts(
        counts, NFFT, SLAB_INPUT["L"], SLAB_INPUT["a"], SLAB_INPUT["mp"]))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < SLAB_BOUND * scale
    assert np.abs(got - one).max() < SLAB_ONE_DEVICE * np.abs(one).max()


# ---------------------------------------------------------------------------
# the multigrid step
# ---------------------------------------------------------------------------

def test_mg_step_on_two_ranks_matches_jax_sharded_step(runs):
    """The NGP step on 2 ranks against the JAX package's step on its
    2-device mesh (mgdriver._deposit_patches_sharded, spec=plan.spec), the
    same preset patches and initial rays: JAX's own bound."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from calclens_tpu import config as jconfig
    from calclens_tpu import mgdriver as jmgd
    from calclens_tpu.driver import Raytracer as JRaytracer
    from calclens_tpu.parallel.sharding import AXIS, make_mesh
    from calclens_tpu_torch.driver import Raytracer

    tmp = runs[0]
    init = Raytracer(mg_cfg(tmp), device="cpu")
    init.init_rays()
    mesh = make_mesh(2)
    jrt = JRaytracer(mg_cfg(tmp, jconfig.RayTraceConfig), mesh=mesh)
    jrt.mgsetup = jmgd.MGSetup(2, MG_N, 6, dtype=jnp.float64)
    jrt.init_rays()
    jrt.rays_packed = jax.device_put(init.rays_packed.numpy(),
                                     NamedSharding(mesh, P(None, AXIS)))
    jrt.step(MASS_PLANE)
    got = _two(runs, "NGP")[0][0]
    np.testing.assert_allclose(got, np.asarray(jrt.rays_packed),
                               rtol=MG_RTOL, atol=MG_ATOL)


@pytest.mark.parametrize("n,label", [(2, "NGP"), (2, "SPH conv"),
                                     (2, "CIC box"), (4, "NGP"),
                                     (4, "SPH conv")])
def test_mg_step_on_ranks_matches_one_device_port(runs, one, n, label):
    """The step on 2 and 4 ranks (the CIC box on 2) against the port's
    one-device step at JAX's bound; every rank's V-cycles equal the
    one-device solve's (with MGConvFact the stop test covers every rank's
    patches)."""
    res = _two(runs, label) if n == 2 else _four(runs, label)
    assert len(res) == n
    ref, cycles = one[label]
    for packed, c in res:
        np.testing.assert_allclose(packed, ref, rtol=MG_RTOL, atol=MG_ATOL)
        assert c == cycles
    if label == "SPH conv":
        assert 1 < cycles < 20
    else:
        assert cycles == 10


# ---------------------------------------------------------------------------
# THREEDPOT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_threedpot_on_ranks_matches_one_device_port(runs, one, n):
    """Raytracer.run over TDP_PLANES planes on n ranks against one device:
    TDP_BOUND of each quantity's max; one grid build on every rank; each
    rank read its share (file f on rank f mod 2 on 2 ranks, a block of
    each file's rows on 4), and the shares and the reduce-scattered counts
    sum to the snapshot's particles; rank 0 wrote the files one device
    writes, the lens maps with the same ray counts."""
    from calclens_tpu_torch.io import fits

    res = _two(runs, "threedpot") if n == 2 else _four(runs, "threedpot")
    assert len(res) == n
    ref = one["threedpot"]
    for r in res:
        assert _row_err(r["packed"], ref["packed"]) < TDP_BOUND
        assert r["builds"] == 1
    assert ref["builds"] == 1 and ref["rows"] == 6000
    assert sum(r["rows"] for r in res) == 6000
    # float32 counts, summed in float64: phase 14's bound on the total
    assert abs(sum(r["totals"][0] for r in res) - 6000.0) < 1e-6 * 6000.0
    if n == 2:
        assert [[f[1] for f in r["files"]] for r in res] == [[None]] * 2
        assert [r["files"][0][0][-2:] for r in res] == [".0", ".1"]
    else:
        assert [len(r["files"]) for r in res] == [2] * 4
    names = ref["written"]
    assert res[0]["written"] == names
    maps = [f for f in names if f.startswith("Rays_")]
    assert len(maps) == 2 and len([f for f in names
                                   if f.startswith("rays_")]) == 2
    for name in maps:
        counts = [fits.read_fits(os.path.join(runs[0], d, name))[1][1][
            "N_RAYS"] for d in ("tdp1", f"tdp{n}")]
        np.testing.assert_array_equal(counts[1], counts[0])
