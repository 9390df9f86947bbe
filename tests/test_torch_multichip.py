"""The port on a mesh of ranks (torch.distributed, gloo, CPU) against the
JAX package's sharded path on its virtual CPU devices (tests/conftest.py)
and the port's one-device path.

One spawn of 4 ranks (calclens_tpu_torch.parallel.launch.run_ranks, a
FileStore under the test's tmp dir, its own 120 s timeout) runs every case
of this module.  The pairs of ranks (0, 1) and (2, 3) first run the 2-rank
cases, each pair on a group of its own (a Mesh over dist.new_group): the
plane steps on the first, run() on the second; then all four run the
4-rank cases.  The tests compare the ranks' results
in this process.  The ranks import neither jax nor calclens_tpu: this
module imports them inside the tests only.

2 ranks, SHTOrder 5 / rayOrder 5, 4096 particles at pixel centres: the
NGP, SPH and CIC-box float64 steps against JAX's 2-device steps (1e-10 of
each quantity's max) and the port's one-device steps; the float32 step at
JAX's own sharded-vs-single bound; 4 forced j-blocks; whole-plane particle
tensors; ranks given different planes; and a 3-plane Raytracer.run() with
lens maps, two ray files, galaxy images and its sharded checkpoint against
one rank (1e-12; ray files byte-equal), the checkpoint resumed across 2 ->
1 rank, 1 -> 2 ranks and (at the end of the 4-rank cases) 2 -> 4 ranks,
and the npz restart the 2 ranks write after run() resumed in JAX.

4 ranks: the float64 step against JAX's 4-device step, the float32 step
against the port's one-device step, and the sharded galaxy searches at
rayOrder 4, whose ray halo spans more than one rank's block (the multi-hop
window), against JAX's sharded searches and the port's one-device ones.
"""
import os
import sys

import numpy as np
import pytest
import torch

from calclens_tpu_torch.config import RayTraceConfig
from calclens_tpu_torch.healpix import core as hp
from calclens_tpu_torch.parallel.launch import run_ranks

ORDER = 5
NPART = 4096
BOX = dict(minRa=0.0, maxRa=90.0, minDec=0.0, maxDec=90.0)
DEPOSITS = {"SPH": dict(DepositScheme="SPH"),
            "CIC box": dict(DepositScheme="CIC", **BOX)}
# JAX's own bound between its sharded and one-device float32 steps
# (tests/test_multichip.py::test_sharded_step_matches_single_device)
F32_RTOL, F32_ATOL = 5e-5, 5e-6
GAL_ORDER = 4
WPM1, WPM2 = 625.0, 375.0


def _cfg(precision="f64", **kw):
    base = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                SHTOrder=ORDER, rayOrder=ORDER, bundleOrder=3,
                Precision=precision)
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _particles(order=ORDER, seed=7):
    """Particles at distinct map-pixel centres (no NGP knife edges), at the
    radius of plane 0 of the test configuration."""
    rng = np.random.default_rng(seed)
    pix = rng.choice(int(hp.order2npix(order)), size=NPART, replace=False)
    th, ph = hp.pix2ang_ring(pix, order)
    v = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], axis=1)
    return v * 125.0, np.full(NPART, 1.0e12)


def _step(mesh, precision="f64", stream=None, with_maps=False, staged=False,
          **kw):
    """One plane-0 step of the port (on `mesh`, or one device when None):
    (the whole packed buffer after the step, the whole six maps or None).
    staged: the particles go in as the whole plane's tensors from
    Raytracer.stage_particles, as a caller that stages them does."""
    from calclens_tpu_torch.driver import Raytracer

    rt = Raytracer(_cfg(precision, **kw), device="cpu", mesh=mesh)
    if stream is not None:
        rt.plan.synth_stream = stream
    rt.init_rays()
    pos, mass = _particles()
    if staged:
        pos, mass = rt.stage_particles(pos, mass)
    maps = rt.step(0, pos, mass, with_maps=with_maps)
    if maps is not None:
        maps = torch.stack(list(maps))
        if mesh is not None:
            maps = mesh.all_gather_cols(maps, rt.plan.pix_bounds)
        maps = maps.numpy()
    return rt.packed_global().numpy(), maps


def _different_planes(mesh):
    """Rank 0 is given the plane's particles, the others an empty plane:
    every rank raises (none waits in a collective), with this message."""
    from calclens_tpu_torch.driver import Raytracer

    rt = Raytracer(_cfg(), device="cpu", mesh=mesh)
    rt.init_rays()
    pos, mass = _particles()
    if mesh.rank:
        pos, mass = pos[:0], mass[:0]
    try:
        rt.step(0, pos, mass)
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# run(): a 3-plane point-mass trace with every output
# ---------------------------------------------------------------------------

def _run_cfg(tmp, out):
    return RayTraceConfig(
        OmegaM=0.3, maxComvDistance=800.0, NumLensPlanes=3,
        LensPlanePath=os.path.join(tmp, "planes"), LensPlaneName="pm",
        SHTOrder=5, rayOrder=5, bundleOrder=2, partMass=1.0e15,
        raPointMass=40.0, decPointMass=10.0, radPointMass=400.0,
        PointMassTest=True, Precision="f64",
        MapRedshiftList=os.path.join(tmp, "zs"), LensMapOrder=3,
        RayOutputName="rays_", NumRayOutputFiles=2,
        GalsFileList=os.path.join(tmp, "gals.txt"), GalOutputName="gal_",
        OutputPath=str(out)).finalize()


def _run(mesh, tmp, out, resume_from=None):
    """run() into `out` (on `mesh`, or one device when None), which writes
    its sharded checkpoint; on a mesh the npz restart too (gathered to rank
    0, the file the JAX package reads).  Then, when resume_from is a
    directory, a new Raytracer loads the sharded checkpoint there.  Returns
    (the final whole packed buffer, (the resumed one, its plane) or
    None)."""
    from calclens_tpu_torch.driver import Raytracer

    rt = Raytracer(_run_cfg(tmp, out), device="cpu", mesh=mesh)
    rt.run(progress=False)
    if mesh is not None:
        rt.save_restart()
    final = rt.packed_global().numpy()
    resumed = None
    if resume_from is not None:
        resumed = _resume(mesh, tmp, resume_from)
    return final, resumed


def _resume(mesh, tmp, run_dir):
    """(the whole packed buffer, the plane) of a new Raytracer (on `mesh`,
    or one device) that loads run_dir's sharded checkpoint."""
    from calclens_tpu_torch.driver import Raytracer

    rt = Raytracer(_run_cfg(tmp, run_dir), device="cpu", mesh=mesh)
    rt.load_restart_sharded(os.path.join(run_dir, "restart_sharded"))
    return rt.packed_global().numpy(), rt.current_plane


# ---------------------------------------------------------------------------
# the galaxy search at rayOrder 4
# ---------------------------------------------------------------------------

def deformed_grid(order, seed=21):
    """A deformed full-sky ray grid (packed [21, npix] float64, RING order:
    pixel centres moved by a random tangent field of 1e-3, A perturbed by
    1e-2, as tests/test_torch_gridsearch.py builds it) and 150 sources
    between the two radii."""
    rng = np.random.default_rng(seed)
    npix = int(hp.order2npix(order))
    vec = hp.pix2vec_ring(np.arange(npix, dtype=np.int64), order)
    packed = np.zeros((21, npix))
    tang = rng.normal(size=(3, npix))
    tang -= vec.T * np.einsum("ip,pi->p", tang, vec)
    nvec = vec.T + 1e-3 * tang
    packed[0:3] = nvec / np.linalg.norm(nvec, axis=0, keepdims=True) * WPM1
    packed[3:6] = vec.T
    packed[6] = packed[9] = packed[10] = packed[13] = 1.0
    packed[6] += 1e-2 * rng.normal(size=npix)
    packed[9] += 1e-2 * rng.normal(size=npix)
    g = rng.normal(size=(150, 3))
    gal_pos = g / np.linalg.norm(g, axis=1, keepdims=True)
    return packed, gal_pos * 0.5 * (WPM1 + WPM2 + 300.0)


def _gal_cfg():
    return _cfg(rayOrder=GAL_ORDER, SHTOrder=GAL_ORDER, bundleOrder=2)


def search(mesh, packed, gal_pos, born):
    """The port's search on `packed` (the whole buffer; on a mesh each rank
    passes its columns): the sharded search on a mesh, the one-device
    search without."""
    from calclens_tpu_torch.gals import gridsearch as gs
    from calclens_tpu_torch.healpix import torchhp

    cfg = _gal_cfg()
    tab = torchhp.InterpTables(GAL_ORDER)
    idx = np.arange(len(gal_pos))
    if mesh is not None:
        a, b = mesh.block(packed.shape[1])
        packed = packed[:, a:b]
    x = torch.as_tensor(np.ascontiguousarray(packed))
    if mesh is None:
        fn = gs.find_images_born if born else gs.find_images_device
        return fn(cfg, tab, x, gal_pos, idx, WPM1, WPM2)
    fn = gs.find_images_born_sharded if born else gs.find_images_sharded
    return fn(cfg, tab, x, gal_pos, idx, WPM1, WPM2, mesh)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _pair_cases(mesh, which, tmp, one):
    """The 2-rank cases: the plane steps on ranks 0 and 1 (which 0), run()
    and the ranks given different planes on ranks 2 and 3 (which 1)."""
    out = {}
    if which == 0:
        out["f64"] = _step(mesh)[0]
        out["f64_staged"] = _step(mesh, staged=True)[0]
        out["f32"] = _step(mesh, "f32")[0]
        out["stream_maps"] = _step(mesh, stream=4, with_maps=True)[1]
        for label, kw in DEPOSITS.items():
            out[label] = _step(mesh, **kw)[0]
    else:
        out["different_planes"] = _different_planes(mesh)
        out["run"] = _run(mesh, tmp, os.path.join(tmp, "two"),
                          resume_from=one)
    out["calls"] = dict(mesh.calls)
    return out


def _four_rank_cases(mesh, packed, gal_pos):
    return dict(f64=_step(mesh)[0], f32=_step(mesh, "f32")[0],
                images=search(mesh, packed, gal_pos, False),
                born=search(mesh, packed, gal_pos, True))


def _rank_cases(mesh, tmp, one, packed, gal_pos):
    """Every case of this module on one rank of 4 (run in the spawned
    ranks): the 2-rank cases on the pairs (0, 1) and (2, 3), each a Mesh
    over a group of its own, then the 4-rank cases."""
    import torch.distributed as dist

    from calclens_tpu_torch.parallel.sharding import Mesh

    assert "jax" not in sys.modules and "calclens_tpu" not in sys.modules
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    which = mesh.rank // 2
    out = {"two": _pair_cases(Mesh(mesh.device, pairs[which]), which, tmp,
                              one)}
    mesh.barrier()
    out["four"] = _four_rank_cases(mesh, packed, gal_pos)
    # the 2-rank run()'s checkpoint resumed on the 4 ranks
    out["four"]["resumed"] = _resume(mesh, tmp, os.path.join(tmp, "two"))
    out["jax_loaded"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def grid():
    return deformed_grid(GAL_ORDER)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, grid):
    """(the run()'s tmp dir, the one-rank run()'s final rays, the 4 ranks'
    results): the inputs of run() are written, the one-rank run() goes
    first (the ranks resume its restart), then the ranks."""
    from calclens_tpu_torch.gals import io as gio
    from calclens_tpu_torch.testing import pointmass as pm

    tmp = tmp_path_factory.mktemp("mesh")
    (tmp / "zs").write_text("0.1\n0.2\n")
    rng = np.random.default_rng(23)
    g = rng.normal(size=(120, 3))
    g = g / np.linalg.norm(g, axis=1, keepdims=True)
    gio.write_source_gals(str(tmp / "cat.fit"),
                          g * rng.uniform(300.0, 790.0, (120, 1)))
    (tmp / "gals.txt").write_text(str(tmp / "cat.fit") + "\n")
    pm.make_pointmass_planes(_run_cfg(str(tmp), tmp / "x"),
                             snap_to_pixel_order=5)
    one, _ = _run(None, str(tmp), tmp / "one")
    ranks = run_ranks(_rank_cases, 4, str(tmp / "store"), device="cpu",
                      timeout=120.0,
                      args=(str(tmp), str(tmp / "one"), *grid))
    return tmp, one, ranks


@pytest.fixture(scope="module")
def two(runs):
    """The plane steps' results on ranks 0 and 1."""
    return [r["two"] for r in runs[2][:2]]


@pytest.fixture(scope="module")
def two_run(runs):
    """run()'s results on ranks 2 and 3."""
    return [r["two"] for r in runs[2][2:]]


@pytest.fixture(scope="module")
def four(runs):
    return [r["four"] for r in runs[2]]


@pytest.fixture(scope="module")
def f32_one_device():
    """The port's one-device float32 step, held against both meshes."""
    return _step(None, "f32")[0]


# the packed rows of each quantity: n, beta, A, Aprev, alpha, U, phi
GROUPS = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))


def _row_err(got, ref, groups=GROUPS):
    """Max over rows of |got - ref| / max |ref| of the row's quantity
    (each map its own quantity when groups is None)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if groups is None:
        groups = [(i, i + 1) for i in range(len(ref))]
    worst = 0.0
    for a, b in groups:
        scale = np.abs(ref[a:b]).max() + 1e-300
        worst = max(worst, float(np.abs(got[a:b] - ref[a:b]).max() / scale))
    return worst


def _jax_step(n, **kw):
    """The JAX package's float64 step on its n-device mesh from the port's
    initial rays (the JAX float64 full-sky init starts from float32 pixel
    centres), the same particles: the whole packed buffer after it.  The
    SPH step runs phase-split (Profile 1), the same function compiled in
    pieces, in about half the fused step's compile time."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from calclens_tpu.driver import Raytracer as JRaytracer
    from calclens_tpu.parallel.sharding import AXIS, make_mesh
    from calclens_tpu_torch.driver import Raytracer

    init = Raytracer(_cfg(**kw), device="cpu")
    init.init_rays()
    mesh = make_mesh(n)
    sph = kw.get("DepositScheme") == "SPH"
    jrt = JRaytracer(_cfg(Profile=sph, **kw), mesh=mesh)
    jrt.init_rays()
    jrt.rays_packed = jax.device_put(init.rays_packed.numpy(),
                                     NamedSharding(mesh, P(None, AXIS)))
    jrt.step(0, *_particles())
    return np.asarray(jrt.rays_packed)


# ---------------------------------------------------------------------------
# 2 ranks: the plane step
# ---------------------------------------------------------------------------

def test_ranks_agree_and_import_no_jax(runs, two):
    """Both ranks hold the same whole buffers; no rank imported JAX; the
    collectives of the step ran (reduce-scatter, all-to-alls)."""
    for k in ("f64", "f32", *DEPOSITS):
        np.testing.assert_array_equal(two[0][k], two[1][k])
    assert not any(r["jax_loaded"] for r in runs[2])
    assert two[0]["calls"]["reduce_scatter"] >= 5
    assert two[0]["calls"]["all_to_all"] >= 5


def test_staged_particles_are_the_whole_plane(two):
    """The whole plane's tensors from Raytracer.stage_particles (each rank
    keeps its block of them in step) give the step that the whole host
    arrays give."""
    np.testing.assert_array_equal(two[0]["f64_staged"], two[0]["f64"])


def test_ranks_given_different_planes_raise_together(two_run):
    """The pair's first rank given the particles and its second an empty
    plane: both raise, so neither waits in a collective the other never
    calls."""
    for r in two_run:
        assert r["different_planes"] is not None
        assert "particle counts [4096, 0]" in r["different_planes"]


def test_make_mesh_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                           monkeypatch):
    """make_mesh with no device takes cuda:<rank> under gloo as under
    NCCL, and raises before joining a group when CUDA is missing."""
    import torch.distributed as dist

    from calclens_tpu_torch.parallel.sharding import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:0 asked for"):
        make_mesh("gloo", f"file://{tmp_path}/store", 0, 1)
    assert not dist.is_initialized()


def test_float32_step_matches_one_device_port(two, f32_one_device):
    np.testing.assert_allclose(two[0]["f32"], f32_one_device, rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_streamed_synthesis_on_two_ranks_matches_unstreamed(two):
    """4 forced j-blocks on 2 ranks against the one-device unstreamed
    synthesis: the same six maps to float64 rounding."""
    _, ref = _step(None, with_maps=True)
    assert _row_err(two[0]["stream_maps"], ref, None) < 1e-12


def test_sph_step_matches_one_device_port(two):
    ref, _ = _step(None, **DEPOSITS["SPH"])
    assert _row_err(two[0]["SPH"], ref) < 1e-11


def test_cut_sky_cic_step_matches_one_device_port(two):
    """A box: the ray columns are not the full sky's, so the ray side
    reads the maps gathered whole."""
    ref, _ = _step(None, **DEPOSITS["CIC box"])
    assert _row_err(two[0]["CIC box"], ref) < 1e-11


def test_float64_step_matches_jax_sharded_step(two):
    """The JAX package's step on its 2-device mesh: 1e-10 of each
    quantity's max."""
    assert _row_err(two[0]["f64"], _jax_step(2)) < 1e-10


@pytest.mark.parametrize("label", list(DEPOSITS))
def test_deposit_step_matches_jax_sharded_step(two, label):
    """The SPH step (8 bucket maps reduce-scattered, 8 analyses) and a CIC
    box (maps gathered whole for the ray side) on 2 ranks against the JAX
    package's step on its 2-device mesh: 1e-10 of each quantity's max."""
    assert _row_err(two[0][label], _jax_step(2, **DEPOSITS[label])) < 1e-10


# ---------------------------------------------------------------------------
# 2 ranks: run()
# ---------------------------------------------------------------------------

def _files(d, prefix):
    return sorted(f for f in os.listdir(d) if f.startswith(prefix))


def test_ranks_imported_no_jax_and_agree(runs, two_run):
    assert not any(r["jax_loaded"] for r in runs[2])
    np.testing.assert_array_equal(two_run[0]["run"][0],
                                  two_run[1]["run"][0])


def test_final_rays_match_one_rank(runs, two_run):
    _, one, _ = runs
    scale = np.abs(one).max(axis=1, keepdims=True) + 1e-300
    assert float((np.abs(two_run[0]["run"][0] - one) / scale).max()) < 1e-12


def test_lens_maps_match_one_rank(runs):
    """Convergence_ and Rays_ after planes 1 and 2: the ray counts equal,
    every column within 1e-12 of its max or of 1, whichever is larger
    (kappa = 1 - (A00 + A11) / 2 is a difference of numbers near 1)."""
    from calclens_tpu_torch.io import fits

    tmp = runs[0]
    names = _files(tmp / "one", "Convergence_") + _files(tmp / "one",
                                                         "Rays_")
    assert len(names) == 4 and names == sorted(
        _files(tmp / "two", "Convergence_") + _files(tmp / "two", "Rays_"))
    for name in names:
        a = fits.read_fits(str(tmp / "one" / name))[1][1]
        b = fits.read_fits(str(tmp / "two" / name))[1][1]
        for col in a.dtype.names:
            x = np.asarray(a[col], np.float64)
            y = np.asarray(b[col], np.float64)
            if col in ("NEST_IDX", "N_RAYS"):
                np.testing.assert_array_equal(y, x)
            else:
                assert np.abs(y - x).max() <= 1e-12 * max(
                    np.abs(x).max(), 1.0), (name, col)


def test_ray_files_are_byte_equal_to_one_device_files(runs, two_run):
    """The 2 ranks' ray files (each file's rows gathered to its writing
    rank) against one device's writer on the same final rays: the same
    bytes; and both runs wrote the same files."""
    from calclens_tpu_torch.driver import Raytracer

    tmp = runs[0]
    names = _files(tmp / "one", "rays_")
    assert len(names) == 2 and names == _files(tmp / "two", "rays_")
    rt = Raytracer(_run_cfg(str(tmp), tmp / "two_one"), device="cpu")
    rt.load_state(two_run[0]["run"][0], 3, map_num=2)
    rt.write_rays()
    assert _files(tmp / "two_one", "rays_") == names
    for name in names:
        assert ((tmp / "two_one" / name).read_bytes()
                == (tmp / "two" / name).read_bytes()), name


def test_galaxy_catalogs_hold_the_same_images(runs):
    from calclens_tpu_torch.gals import io as gio

    tmp = runs[0]
    names = _files(tmp / "one", "gal_")
    assert names and names == _files(tmp / "two", "gal_")
    total = 0
    for name in names:
        a = gio.read_image_gals(str(tmp / "one" / name))
        b = gio.read_image_gals(str(tmp / "two" / name))
        oa, ob = (np.lexsort((x["ra"], x["index"])) for x in (a, b))
        np.testing.assert_array_equal(b["index"][ob], a["index"][oa])
        # the JAX search tests' bounds: 1e-8 degrees, A within 1e-10
        for col, tol in (("ra", 1e-8), ("dec", 1e-8), ("A00", 1e-10),
                         ("A01", 1e-10), ("A10", 1e-10), ("A11", 1e-10)):
            np.testing.assert_allclose(b[col][ob], a[col][oa], rtol=0,
                                       atol=tol)
        total += len(a)
    assert total > 0


def test_ranks_resume_the_one_rank_restart(runs, two_run):
    """The one-rank run()'s sharded checkpoint resumed on 2 ranks (1 -> 2):
    the final rays bit for bit."""
    one = runs[1]
    for r in two_run:
        packed, plane = r["run"][1]
        assert plane == 3
        np.testing.assert_array_equal(packed, one)


def test_two_rank_restart_resumes_on_one_port_rank_and_in_jax(runs,
                                                              two_run):
    """The 2 ranks' sharded checkpoint resumes on one port rank (2 -> 1),
    and their restart.npz (save_restart after run(), gathered to rank 0) is
    the file a one-device run writes: one port rank and the JAX driver load
    the same rays from it."""
    from calclens_tpu.driver import Raytracer as JRaytracer
    from calclens_tpu_torch.driver import Raytracer

    tmp = runs[0]
    final = two_run[0]["run"][0]
    packed, plane = _resume(None, str(tmp), str(tmp / "two"))
    assert plane == 3
    np.testing.assert_array_equal(packed, final)
    path = str(tmp / "two" / "restart.npz")
    cfg = _run_cfg(str(tmp), tmp / "two")
    rt = Raytracer(cfg, device="cpu")
    rt.load_restart(path)
    assert rt.current_plane == 3
    np.testing.assert_array_equal(rt.rays_packed.numpy(), final)
    jrt = JRaytracer(cfg)
    jrt.load_restart(path)
    assert jrt.current_plane == 3
    np.testing.assert_array_equal(np.asarray(jrt.rays_packed), final)


def test_four_ranks_resume_the_two_rank_checkpoint(four, two_run):
    """The 2 ranks' sharded checkpoint resumed on 4 ranks (2 -> 4), each
    reading only the shards' parts that overlap its own columns: the final
    rays bit for bit on every rank."""
    final = two_run[0]["run"][0]
    for r in four:
        packed, plane = r["resumed"]
        assert plane == 3
        np.testing.assert_array_equal(packed, final)


# ---------------------------------------------------------------------------
# 4 ranks
# ---------------------------------------------------------------------------

def test_float32_step_on_four_ranks_matches_one_device_port(four,
                                                             f32_one_device):
    np.testing.assert_allclose(four[0]["f32"], f32_one_device,
                               rtol=F32_RTOL, atol=F32_ATOL)


def test_float64_step_on_four_ranks_matches_jax_sharded_step(four):
    """The JAX package's step on its 4-device mesh: 1e-10 of each
    quantity's max."""
    assert _row_err(four[0]["f64"], _jax_step(4)) < 1e-10


def test_galaxy_search_halo_spans_several_blocks():
    """At rayOrder 4 on 4 ranks the search's halo is wider than a rank's
    block of rays, so the window comes from more than one neighbour."""
    from calclens_tpu_torch.gals.gridsearch import ray_halo

    npix = int(hp.order2npix(GAL_ORDER))
    assert ray_halo(GAL_ORDER, 4) > npix // 4


def _same_images(got, ref, ang=0.0, a_tol=0.0):
    """Equal index multisets; ra, dec (degrees) and A within the bounds,
    rows matched by (index, ra)."""
    assert len(ref.index) > 0 and len(got.index) == len(ref.index)
    og, orf = (np.lexsort((x.ra, x.index)) for x in (got, ref))
    np.testing.assert_array_equal(got.index[og], ref.index[orf])
    for f, tol in (("ra", ang), ("dec", ang), ("A", a_tol)):
        np.testing.assert_allclose(getattr(got, f)[og], getattr(ref, f)[orf],
                                   rtol=0, atol=tol)


def test_sharded_search_gives_the_one_device_images(four, grid):
    ref = search(None, *grid, False)
    for r in four:
        _same_images(r["images"], ref)


def test_sharded_born_search_gives_the_one_device_images(four, grid):
    ref = search(None, *grid, True)
    for r in four:
        _same_images(r["born"], ref)


@pytest.mark.parametrize("born", [False, True], ids=["search", "born"])
def test_sharded_search_matches_jax_sharded_search(four, grid, born):
    """The 4 ranks' images against the JAX package's find_images_sharded
    (find_images_born_sharded) on its 4-device mesh, the same deformed
    grid: the JAX search tests' bounds, 1e-8 degrees and A within
    1e-10."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from calclens_tpu.gals import gridsearch as jgs
    from calclens_tpu.healpix import jaxhp
    from calclens_tpu.parallel.sharding import AXIS, make_mesh

    packed, gal_pos = grid
    mesh = make_mesh(4)
    x = jax.device_put(packed, NamedSharding(mesh, P(None, AXIS)))
    fn = jgs.find_images_born_sharded if born else jgs.find_images_sharded
    ref = fn(_gal_cfg(), jaxhp.InterpTables(GAL_ORDER, dtype=jnp.float64),
             x, gal_pos, np.arange(len(gal_pos)), WPM1, WPM2, mesh)
    _same_images(four[0]["born" if born else "images"], ref, 1e-8, 1e-10)
