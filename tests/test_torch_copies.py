"""The port's own copies of the JAX package's host modules against the
originals on the same inputs: config, cosmology, healpix.core (the part the
port calls, the galaxy search's, the legacy restarts' and the lens planes'
helpers included), the io readers (FITS ring weights and pixel windows,
pixLC and HDF5 lens planes) on files written by the JAX package's writers,
the HDF5 plane writer, LGadget snapshots, the lightcone readers and the
lens-plane maker, the point-mass and NFW plane writers and the SPH oracle
(testing/), the precomputed mass maps (io/healpix_maps), utils/profile,
bench.py's reference constants (benchconst), and the host halves of the
multi-device path (parallel/halo.required_halo, gals/gridsearch.ray_halo,
parallel/sharding.pad_to_multiple).
The copies run the same numpy code, so every result must be equal."""
import dataclasses

import numpy as np
import pytest

from calclens_tpu import config as jconfig
from calclens_tpu import cosmology as jcosmo
from calclens_tpu.healpix import core as jhp
from calclens_tpu.io import fits as jfits
from calclens_tpu.io import healpix_maps as jmaps
from calclens_tpu.io import lensplanes as jlens
from calclens_tpu.io import pixlc as jpixlc
from calclens_tpu.io import weights as jweights
from calclens_tpu_torch import config as tconfig
from calclens_tpu_torch import cosmology as tcosmo
from calclens_tpu_torch.healpix import core as thp
from calclens_tpu_torch.io import healpix_maps as tmaps
from calclens_tpu_torch.io import lensplanes as tlens
from calclens_tpu_torch.io import pixlc as tpixlc
from calclens_tpu_torch.io import weights as tweights


def test_read_config_matches_jax(tmp_path):
    text = ("# a reference-format config\n"
            "OmegaM 0.27\nmaxComvDistance\t1500.5\nNumLensPlanes 12\n"
            "LensPlanePath /data/planes\nLensPlaneName lc\n"
            "SHTOrder 9\nrayOrder 8\nbundleOrder 4\nBornApprx 1\n"
            "SmoothingBeamFWHM 0.001\nRayOutputName\nPrecision f64\n"
            f"OutputPath {tmp_path / 'out'}\n")
    path = tmp_path / "raytrace.cfg"
    path.write_text(text)
    ref = jconfig.read_config(str(path))
    used = (tmp_path / "out" / "raytrace.cfg-usedvalues").read_text()
    got = tconfig.read_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.poissonOrder == ref.poissonOrder == 9
    assert got.to_cfg() == ref.to_cfg()
    assert (tmp_path / "out" / "raytrace.cfg-usedvalues").read_text() == used
    assert [f.name for f in dataclasses.fields(tconfig.RayTraceConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.RayTraceConfig)]


@pytest.mark.parametrize("omega_m", [0.25, 0.3])
def test_cosmology_distances_match_jax(omega_m):
    ref, got = jcosmo.Cosmology(omega_m), tcosmo.Cosmology(omega_m)
    a = np.linspace(0.02, 1.0, 301)
    chi = np.linspace(0.0, 5000.0, 301)
    np.testing.assert_array_equal(got.comvdist(a), ref.comvdist(a))
    np.testing.assert_array_equal(got.acomvdist(chi), ref.acomvdist(chi))
    np.testing.assert_array_equal(got.comvdist_z(1 / a - 1),
                                  ref.comvdist_z(1 / a - 1))
    np.testing.assert_array_equal(got.angdist(a), ref.angdist(a))
    np.testing.assert_array_equal(got.angdistdiff(a[:-1], a[1:]),
                                  ref.angdistdiff(a[:-1], a[1:]))
    assert (tcosmo.RHO_CRIT, tcosmo.CSOL, tcosmo.DH) == \
        (jcosmo.RHO_CRIT, jcosmo.CSOL, jcosmo.DH)


@pytest.mark.parametrize("order", [2, 3, 4, 5, 6])
def test_healpix_core_matches_jax(order):
    assert thp.order2npix(order) == jhp.order2npix(order)
    rt, rj = thp.build_ring_table(order), jhp.build_ring_table(order)
    for key in ("startpix", "ringpix", "z", "theta", "shifted"):
        np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key))
    assert (rt.nside, rt.npix, rt.nrings) == (rj.nside, rj.npix, rj.nrings)
    pix = np.arange(int(jhp.order2npix(order)))
    np.testing.assert_array_equal(thp.pix2vec_ring(pix, order),
                                  jhp.pix2vec_ring(pix, order))
    np.testing.assert_array_equal(thp.ring2nest(pix, order),
                                  jhp.ring2nest(pix, order))
    np.testing.assert_array_equal(thp.nest2ring(pix, order),
                                  jhp.nest2ring(pix, order))
    for got, ref in zip(thp.nest2xyf(pix, order), jhp.nest2xyf(pix, order)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(thp.JRLL, jhp.JRLL)
    np.testing.assert_array_equal(thp.JPLL, jhp.JPLL)


@pytest.mark.parametrize("order", [2, 5, 8])
def test_healpix_core_angle_helpers_match_jax(order):
    """vec2ang, ang2radec, ang2pix_ring, pix2ang_nest and pix2vec_nest (the
    cut-sky ray pixels and their initial vectors), on random vectors of
    any length, the poles, and every pixel centre."""
    rng = np.random.default_rng(order)
    vec = rng.normal(size=(5000, 3)) * rng.uniform(0.1, 900.0, (5000, 1))
    vec[:3] = [[0.0, 0.0, 2.0], [0.0, 0.0, -1.0], [1.0, -1e-12, 0.0]]
    for got, ref in zip(thp.vec2ang(vec), jhp.vec2ang(vec)):
        np.testing.assert_array_equal(got, ref)
    th, ph = jhp.vec2ang(vec)
    for got, ref in zip(thp.ang2radec(th, ph), jhp.ang2radec(th, ph)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(thp.ang2pix_ring(th, ph, order),
                                  jhp.ang2pix_ring(th, ph, order))
    pix = np.arange(int(jhp.order2npix(order)))
    for got, ref in zip(thp.pix2ang_nest(pix, order),
                        jhp.pix2ang_nest(pix, order)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(thp.pix2vec_nest(pix, order),
                                  jhp.pix2vec_nest(pix, order))


@pytest.mark.parametrize("order", [2, 3, 5])
def test_healpix_core_search_helpers_match_jax(order):
    """The host helpers of the galaxy search and the legacy restarts:
    ra/dec <-> angles and vectors, ang2pix_nest, vec2pix_nest, the host
    get_interpol, neighbors_nest, build_triangles and nest2peano, on random
    vectors, the poles and every pixel."""
    rng = np.random.default_rng(10 + order)
    vec = rng.normal(size=(3000, 3)) * rng.uniform(0.1, 900.0, (3000, 1))
    vec[:3] = [[0.0, 0.0, 2.0], [0.0, 0.0, -1.0], [1.0, -1e-12, 0.0]]
    ra, dec = jhp.vec2radec(vec)
    for got, ref in zip(thp.vec2radec(vec), (ra, dec)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(thp.radec2ang(ra, dec), jhp.radec2ang(ra, dec)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(thp.radec2vec(ra, dec),
                                  jhp.radec2vec(ra, dec))
    th, ph = jhp.vec2ang(vec)
    np.testing.assert_array_equal(thp.ang2pix_nest(th, ph, order),
                                  jhp.ang2pix_nest(th, ph, order))
    np.testing.assert_array_equal(thp.vec2pix_nest(vec, order),
                                  jhp.vec2pix_nest(vec, order))
    np.testing.assert_array_equal(thp.vec2pix_ring(vec, order),
                                  jhp.vec2pix_ring(vec, order))
    for got, ref in zip(thp.get_interpol(th, ph, order),
                        jhp.get_interpol(th, ph, order)):
        np.testing.assert_array_equal(got, ref)
    pix = np.arange(int(jhp.order2npix(order)))
    np.testing.assert_array_equal(thp.neighbors_nest(pix, order),
                                  jhp.neighbors_nest(pix, order))
    np.testing.assert_array_equal(thp.build_triangles(order),
                                  jhp.build_triangles(order))
    np.testing.assert_array_equal(thp.nest2peano(pix, order),
                                  jhp.nest2peano(pix, order))


def test_healpix_maps_copy_reads_and_writes_as_jax(tmp_path):
    counts = np.random.default_rng(2).uniform(0.0, 9.0, 12 * 4**3)
    jmaps.write_plane_map(str(tmp_path / "j"), "m", 4, counts)
    tmaps.write_plane_map(str(tmp_path / "t"), "m", 4, counts)
    assert tmaps.map_filename("a", "m", 4) == jmaps.map_filename("a", "m", 4)
    assert (tmp_path / "t" / "m.4").read_bytes() == \
        (tmp_path / "j" / "m.4").read_bytes()
    got = tmaps.read_plane_map(str(tmp_path / "j"), "m", 4, len(counts))
    np.testing.assert_array_equal(
        got, jmaps.read_plane_map(str(tmp_path / "j"), "m", 4, len(counts)))
    assert got.dtype == np.float32
    with pytest.raises(ValueError, match="pixels"):
        tmaps.read_plane_map(str(tmp_path / "j"), "m", 4, len(counts) + 1)


def _write_table(path, values):
    rec = np.zeros(len(values), dtype=[("TEMPERATURE", ">f8")])
    rec["TEMPERATURE"] = values
    jfits.write_fits(str(path), [jfits.image_hdu(np.zeros(0, np.int32)),
                                 jfits.bintable_hdu(rec, name="WEIGHTS")])


@pytest.mark.parametrize("order", [2, 4])
def test_weights_readers_match_jax(tmp_path, order):
    nside = 1 << order
    rng = np.random.default_rng(order)
    _write_table(tmp_path / f"weight_ring_n{nside:05d}.fits",
                 1e-3 * rng.normal(size=2 * nside))
    _write_table(tmp_path / f"pixel_window_n{nside:04d}.fits",
                 np.linspace(1.0, 0.5, 4 * nside + 1))
    for reader in ("read_ring_weights", "read_pixel_window"):
        got = getattr(tweights, reader)(str(tmp_path), order)
        ref = getattr(jweights, reader)(str(tmp_path), order)
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.float64
    # a table of the wrong length is refused
    short = tmp_path / "short"
    short.mkdir()
    _write_table(short / f"weight_ring_n{nside:05d}.fits", np.zeros(nside))
    with pytest.raises(ValueError, match="rows"):
        tweights.read_ring_weights(str(short), order)


def test_pixlc_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    for nest, n in ((0, 50), (3, 0), (5, 20), (11, 7)):
        jpixlc.write_cell(str(tmp_path), "lc", 4, nest,
                          rng.normal(size=(n, 3)) * 100.0, 2.5 + nest,
                          filenside=1)
    got = tpixlc.read_plane(str(tmp_path), "lc", 4)
    ref = jpixlc.read_plane(str(tmp_path), "lc", 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert len(got[0]) == 77
    empty = tpixlc.read_plane(str(tmp_path), "lc", 5)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0,)
    assert tpixlc.read_header(tpixlc.cell_filename(str(tmp_path), "lc", 4, 5)
                              ) == jpixlc.read_header(
        jpixlc.cell_filename(str(tmp_path), "lc", 4, 5))


def test_lensplanes_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    pos = rng.normal(size=(300, 3)) * 200.0
    mass = rng.uniform(1e11, 1e12, size=300)
    fn = tlens.plane_filename(str(tmp_path), "plane", 3)
    assert fn == jlens.plane_filename(str(tmp_path), "plane", 3)
    jlens.write_plane(fn, 2, pos, mass)
    got = tlens.read_plane(fn)
    ref = jlens.read_plane(fn)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0].shape == (300, 3)


def test_profiler_matches_jax(tmp_path, monkeypatch):
    """utils/profile.Profiler fed the intervals that the JAX package's
    Profiler times between toggles: the same totals, counts, report and
    timing file."""
    import torch

    from calclens_tpu.utils import profile as jprof
    from calclens_tpu_torch.utils import profile as tprof

    ticks = iter(np.cumsum(np.arange(1.0, 40.0) * 0.125))
    monkeypatch.setattr(jprof.time, "perf_counter", lambda: next(ticks))
    jp, tp = jprof.Profiler(keep_timeseries=True), tprof.Profiler()
    for tag in ("STEPTIME", "SHT", "SHT", "RAYPROP", "RAYPROP", "SHT",
                "SHT", "STEPTIME", "DEPOSIT", "DEPOSIT"):
        jp.log_tag(tag)
    for tag, start, stop in jp.series:
        tp.add(tag, stop - start)
    assert len(jp.series) == 5
    assert (tp.total, tp.count, tp.report()) == (jp.total, jp.count,
                                                   jp.report())
    jp.write(str(tmp_path / "jax"))
    tp.write(str(tmp_path / "port"))
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()
    # the port's device sync: nothing to wait for on a CPU tensor
    tprof.sync(torch.zeros(3))


def test_bench_constants_match_bench_py():
    """calclens_tpu_torch/benchconst.py against bench.py's own constants
    and reference_step_seconds (read from its source: importing bench.py
    would configure the JAX compilation cache)."""
    import ast
    import os

    from calclens_tpu_torch import benchconst as bc

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "bench.py")) as fp:
        tree = ast.parse(fp.read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign) and n.targets[0].id in (
                "REF_MEASURED_STEP_S", "REF_CLUSTER_CORES"))
            or (isinstance(n, ast.FunctionDef)
                and n.name == "reference_step_seconds")]
    assert len(keep) == 3
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "bench.py", "exec"),
         ns)
    assert bc.REF_MEASURED_STEP_S == ns["REF_MEASURED_STEP_S"]
    assert bc.REF_CLUSTER_CORES == ns["REF_CLUSTER_CORES"]
    for order in range(6, 15):
        assert bc.reference_step_seconds(order) == \
            ns["reference_step_seconds"](order)
        for ray_order in (8, 10, 11, 13):
            # bench.py main()'s ray scaling
            want = ns["reference_step_seconds"](order) * (
                1.0 if ray_order <= 10 else
                1.0 + 0.012 * (4.0 ** (ray_order - 10) - 1.0))
            assert bc.reference_core_step_seconds(order, ray_order) == want


def _h5_datasets(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}


def _same_h5(got_path, ref_path):
    got, ref = _h5_datasets(got_path), _h5_datasets(ref_path)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
        assert got[key].dtype == ref[key].dtype, key


@pytest.mark.parametrize("order", [2, 3, 5])
def test_healpix_core_plane_helpers_match_jax(order):
    """peano2nest (the subset plane reads) and query_disc (the SPH oracle)."""
    pix = np.arange(int(jhp.order2npix(order)))
    np.testing.assert_array_equal(thp.peano2nest(pix, order),
                                  jhp.peano2nest(pix, order))
    np.testing.assert_array_equal(thp.peano2nest(thp.nest2peano(pix, order),
                                                 order), pix)
    for theta, phi, radius in ((0.3, 1.0, 0.2), (0.0, 0.0, 0.05),
                               (2.9, 5.5, 0.6), (1.57, 3.1, 0.01)):
        np.testing.assert_array_equal(
            thp.query_disc(theta, phi, radius, order),
            jhp.query_disc(theta, phi, radius, order))


def test_lgadget_copy_writes_and_reads_as_jax(tmp_path):
    from calclens_tpu.io import lgadget as jlg
    from calclens_tpu_torch.io import lgadget as tlg

    for args in ((5, 2.5, 0.7, 0.4, 5, 1, 1000.0, 0.3, 0.7, 0.7),
                 (7, 1.0, 1.0, 0.0, (3 << 32) + 11, 8, 50.0, 0.25, 0.75,
                  0.68)):
        assert tlg.write_header(*args) == jlg.write_header(*args)
    pos = np.random.default_rng(3).uniform(-5.0, 505.0, (777, 3))
    kw = dict(mass1_1e10=4.5, time=0.6, boxsize=500.0, num_files=2,
              npart_total=1554)
    jlg.write_snapshot(str(tmp_path / "j.0"), pos, **kw)
    tlg.write_snapshot(str(tmp_path / "t.0"), pos, **kw)
    assert (tmp_path / "t.0").read_bytes() == (tmp_path / "j.0").read_bytes()
    fn = str(tmp_path / "j.0")
    assert tlg.read_header(fn) == jlg.read_header(fn)
    got, ref = tlg.read_positions(fn), jlg.read_positions(fn)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].dtype == ref[0].dtype and got[2] == ref[2]
    raw, hd = tlg.read_positions_f32(fn)
    assert raw.dtype == np.float32 and hd == ref[2]
    np.testing.assert_array_equal(raw.astype(np.float64), ref[0])


def test_lightcone_copy_matches_jax(tmp_path):
    """The GADGET2 and ARTLC writers write the same bytes, the readers and
    chunk iterators give the same arrays."""
    from calclens_tpu.io import lightcone as jlc
    from calclens_tpu_torch.io import lightcone as tlc

    rng = np.random.default_rng(5)
    pos = rng.normal(size=(900, 3)) * 300.0
    vel = rng.normal(size=(900, 3))
    g2 = dict(vel=vel, npart_by_type=(100, 800, 0, 0, 0, 0),
              mass_by_type=(3.0, 1.5, 0, 0, 0, 0), time=0.7)
    jlc.write_gadget2(str(tmp_path / "j.g2"), pos, **g2)
    tlc.write_gadget2(str(tmp_path / "t.g2"), pos, **g2)
    jlc.write_artlc(str(tmp_path / "j.art"), pos, vel=vel,
                    partid=np.arange(900) * 2)
    tlc.write_artlc(str(tmp_path / "t.art"), pos, vel=vel,
                    partid=np.arange(900) * 2)
    for ext in ("g2", "art"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    g2f, artf = str(tmp_path / "j.g2"), str(tmp_path / "j.art")
    got, ref = tlc.read_gadget2(g2f), jlc.read_gadget2(g2f)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, r)
    assert got[3] == ref[3]
    for g, r in zip(tlc.read_artlc(artf), jlc.read_artlc(artf)):
        np.testing.assert_array_equal(g, r)
    for t_it, j_it in (
            (tlc.gadget2_chunks([g2f], 1e10, 1e-3, 256),
             jlc.gadget2_chunks([g2f], 1e10, 1e-3, 256)),
            (tlc.artlc_chunks([artf], 2e11, 256),
             jlc.artlc_chunks([artf], 2e11, 256))):
        t_l, j_l = list(t_it), list(j_it)
        assert len(t_l) == len(j_l) == 4
        for (gp, gm), (rp, rm) in zip(t_l, j_l):
            np.testing.assert_array_equal(gp, rp)
            np.testing.assert_array_equal(gm, rm)


def test_lensplanes_writer_and_subset_reader_match_jax(tmp_path):
    """write_plane writes JAX's datasets; read_plane of every cell and of
    a subset of cells at the file's order, a coarser and a finer one reads
    JAX's particles."""
    rng = np.random.default_rng(9)
    pos = rng.normal(size=(500, 3)) * 400.0
    mass = rng.uniform(1e11, 1e12, 500)
    vel = rng.normal(size=(500, 3))
    jfn = str(tmp_path / "j.h5")
    tfn = str(tmp_path / "t.h5")
    jlens.write_plane(jfn, 3, pos, mass, vel=vel, partid=np.arange(500) + 7)
    tlens.write_plane(tfn, 3, pos, mass, vel=vel, partid=np.arange(500) + 7)
    _same_h5(tfn, jfn)
    assert tlens.LCPARTICLE_DTYPE == jlens.LCPARTICLE_DTYPE
    for cells, order in ((None, None), ([0, 5, 77, 700], 3), ([1, 9], 2),
                         (list(range(40, 300)), 4)):
        got = tlens.read_plane(jfn, cells, order)
        ref = jlens.read_plane(jfn, cells, order)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        if cells is not None:
            assert tlens._file_cells_for(cells, order, 3) == \
                jlens._file_cells_for(cells, order, 3)
    assert len(tlens.read_plane(jfn, [1, 9], 2)[0]) > 0


def test_lensplane_maker_copy_matches_jax(tmp_path):
    """lgadget_chunks, make_lensplanes (PlaneWriter's appends over several
    chunks) and make_debug_maps: the same chunks, plane files and maps."""
    from calclens_tpu import lensplane_maker as jmk
    from calclens_tpu.io import lgadget as jlg
    from calclens_tpu_torch import lensplane_maker as tmk

    rng = np.random.default_rng(12)
    v = rng.normal(size=(3000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = v * rng.uniform(1.0, 1000.0, (3000, 1))
    pos[:2] = [[0.0, 0.0, 1000.0], [999.9999, 0.0, 0.0]]  # the last shell
    fn = str(tmp_path / "lc.0")
    jlg.write_snapshot(fn, pos, mass1_1e10=2.0)
    t_l = list(tmk.lgadget_chunks([fn], chunk=1000))
    j_l = list(jmk.lgadget_chunks([fn], chunk=1000))
    assert len(t_l) == len(j_l) == 3
    for (gp, gm), (rp, rm) in zip(t_l, j_l):
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(gm, rm)
    kw = dict(num_planes=5, max_comv_distance=1000.0, lens_plane_order=2,
              mass_conv=1.5, length_conv=1.0, partid_start=10)
    counts_t = tmk.make_lensplanes(iter(t_l), str(tmp_path / "t"), "p", **kw)
    counts_j = jmk.make_lensplanes(iter(j_l), str(tmp_path / "j"), "p", **kw)
    assert counts_t == counts_j and sum(counts_t) == 3000
    for p in range(5):
        _same_h5(tlens.plane_filename(str(tmp_path / "t"), "p", p),
                 jlens.plane_filename(str(tmp_path / "j"), "p", p))
    np.testing.assert_array_equal(
        tmk.make_debug_maps(str(tmp_path / "j"), "p", 5, map_order=3),
        jmk.make_debug_maps(str(tmp_path / "j"), "p", 5, map_order=3))


def test_pointmass_copy_matches_jax(tmp_path):
    """The point-mass and NFW plane writers write JAX's planes, and every
    analytic helper gives JAX's values."""
    from calclens_tpu.testing import pointmass as jpm
    from calclens_tpu_torch.testing import pointmass as tpm

    kw = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=4,
              LensPlaneName="pm", SHTOrder=4, rayOrder=4, bundleOrder=2,
              partMass=5.0e15, raPointMass=32.0, decPointMass=14.0,
              radPointMass=625.0, PointMassTest=True)
    for snap in (None, 4):
        jc = jconfig.RayTraceConfig(LensPlanePath=str(tmp_path / f"j{snap}"),
                                    **kw).finalize()
        tc = tconfig.RayTraceConfig(LensPlanePath=str(tmp_path / f"t{snap}"),
                                    **kw).finalize()
        (tv, tp), (jv, jp) = (tpm.make_pointmass_planes(tc, snap),
                              jpm.make_pointmass_planes(jc, snap))
        np.testing.assert_array_equal(tv, jv)
        assert tp == jp
        for p in range(4):
            _same_h5(tlens.plane_filename(tc.LensPlanePath, "pm", p),
                     jlens.plane_filename(jc.LensPlanePath, "pm", p))
    jc = jconfig.RayTraceConfig(LensPlanePath=str(tmp_path / "jn"),
                                **kw).finalize()
    tc = tconfig.RayTraceConfig(LensPlanePath=str(tmp_path / "tn"),
                                **kw).finalize()
    got = tpm.make_nfw_planes(tc, n_parts=2000, seed=4)
    ref = jpm.make_nfw_planes(jc, n_parts=2000, seed=4)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    for p in range(4):
        _same_h5(tlens.plane_filename(tc.LensPlanePath, "pm", p),
                 jlens.plane_filename(jc.LensPlanePath, "pm", p))
    gamma = np.linspace(0.01, 0.5, 40)
    tco, jco = tcosmo.Cosmology(0.3), jcosmo.Cosmology(0.3)
    q = jpm.charge(jc, jco, 625.0)
    assert tpm.charge(tc, tco, 625.0) == q
    assert tpm.G_OVER_C2 == jpm.G_OVER_C2
    bl = np.exp(-np.arange(41) / 30.0)
    for name, args in (("alpha_exact", (gamma, q)),
                       ("alpha_smallangle", (gamma, q)),
                       ("alpha_bandlimited", (gamma, q, 40)),
                       ("alpha_bandlimited", (gamma, q, 40, bl)),
                       ("shear_tangential", (gamma, q, 625.0, 1500.0)),
                       ("nfw_rho", (gamma * 10.0, 1.2, 5.0)),
                       ("nfw_mass_2d", (np.append(gamma, 0.24), 1.2, 5.0,
                                        1e14))):
        np.testing.assert_array_equal(getattr(tpm, name)(*args),
                                      getattr(jpm, name)(*args))
    np.testing.assert_array_equal(
        tpm.sample_nfw(np.random.default_rng(2), 500, 1.2, 5.0),
        jpm.sample_nfw(np.random.default_rng(2), 500, 1.2, 5.0))
    np.testing.assert_array_equal(
        tpm.alpha_nfw(gamma, tc, tco, 625.0, 1.2, 5.0, 1e14),
        jpm.alpha_nfw(gamma, jc, jco, 625.0, 1.2, 5.0, 1e14))


def test_sph_oracle_copy_matches_jax():
    """deposit_sph_exact: the same RING map, adaptive query orders and the
    NGP fallback included."""
    from calclens_tpu.testing import sph_oracle as jso
    from calclens_tpu_torch.testing import sph_oracle as tso

    rng = np.random.default_rng(6)
    pos = rng.normal(size=(12, 3)) * 500.0
    mass = rng.uniform(1e12, 1e13, 12)
    sl = np.concatenate([rng.uniform(0.02, 0.4, 11), [1e-4]])
    np.testing.assert_array_equal(tso.deposit_sph_exact(4, pos, mass, sl),
                                  jso.deposit_sph_exact(4, pos, mass, sl))
    assert tso.SMOOTHKERN_SHTRESOLVE_FAC == jso.SMOOTHKERN_SHTRESOLVE_FAC


# the (rayOrder, map order, shards) list of tests/test_multichip.py's halo
# bound, and halos wider than a block (8 shards at order 3)
HALO_CASES = [(5, 5, 8), (6, 4, 8), (4, 6, 8), (7, 7, 8), (5, 7, 4),
              (3, 3, 8), (10, 12, 2)]


@pytest.mark.parametrize("ray_order,map_order,n", HALO_CASES)
def test_halo_sizes_match_jax(ray_order, map_order, n):
    import warnings

    from calclens_tpu.gals import gridsearch as jgs
    from calclens_tpu.parallel import halo as jhalo
    from calclens_tpu.parallel import sharding as jsharding
    from calclens_tpu_torch.gals import gridsearch as tgs
    from calclens_tpu_torch.parallel import halo as thalo
    from calclens_tpu_torch.parallel import sharding as tsharding

    for drift in (0.0, 0.02):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            ref = jhalo.required_halo(ray_order, map_order, n, drift)
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            got = thalo.required_halo(ray_order, map_order, n, drift)
        assert got == ref
        assert len(wt) == len(wj)
    assert tgs.ray_halo(ray_order, n) == jgs.ray_halo(ray_order, n)
    for k in (1, 7, 4096):
        assert (tsharding.pad_to_multiple(ray_order * 1000 + 3, k)
                == jsharding.pad_to_multiple(ray_order * 1000 + 3, k))
