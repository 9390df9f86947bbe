"""The port's galaxy image search (calclens_tpu_torch/gals/,
rays/paratrans.py, healpix/torchhp.triangles_ring / ring_window) against
calclens_tpu on the same numpy inputs, on the CPU, float64.

Inputs: a synthetic deformed ray grid at rayOrder 5 (the pixel centres
moved by a random tangent field of 1e-3, A perturbed by 1e-2, as
tests/test_gridsearch.py builds it), and one port trace at SHTOrder 6 /
rayOrder 5 through a point mass.  Both packages search the same packed
buffer.

Tolerances: triangles, ring windows and written files exact; the parallel
transport 1e-12; images as the JAX tests bound them: equal index multisets,
ra and dec within 1e-8 degrees, A within 1e-10; whole runs started from one
state (two FFT libraries in the SHT solve, as tests/test_torch_raytrace.py)
within 1e-7 degrees and 1e-9 on A."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.config import RayTraceConfig
from calclens_tpu.driver import Raytracer as JRaytracer
from calclens_tpu.gals import concat as jconcat
from calclens_tpu.gals import gridsearch as jgs
from calclens_tpu.gals import io as jgio
from calclens_tpu.healpix import core as hp
from calclens_tpu.healpix import jaxhp
from calclens_tpu.io import fits as jfits
from calclens_tpu.rays import paratrans as jpt
from calclens_tpu.testing import pointmass as pm
from calclens_tpu_torch.driver import Raytracer as TRaytracer
from calclens_tpu_torch.driver import plane_params
from calclens_tpu_torch.gals import concat as tconcat
from calclens_tpu_torch.gals import gridsearch as tgs
from calclens_tpu_torch.gals import io as tgio
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.rays import paratrans as tpt

ORDER = 5
WPM1, WPM2 = 625.0, 375.0
CHUNK = 256  # one compiled shape for every JAX search below


def _cfg(**kw):
    base = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                rayOrder=ORDER, bundleOrder=2, SHTOrder=ORDER,
                Precision="f64")
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _unit(rng, n):
    g = rng.normal(size=(n, 3))
    return g / np.linalg.norm(g, axis=1, keepdims=True)


def assert_same_images(got, ref, ang=1e-8, a_tol=1e-10):
    """Equal index multisets; ra, dec (degrees) and A close, rows matched
    by (index, ra)."""
    assert len(got.index) == len(ref.index)
    og, orf = (np.lexsort((x.ra, x.index)) for x in (got, ref))
    np.testing.assert_array_equal(got.index[og], ref.index[orf])
    np.testing.assert_allclose(got.ra[og], ref.ra[orf], rtol=0, atol=ang)
    np.testing.assert_allclose(got.dec[og], ref.dec[orf], rtol=0, atol=ang)
    np.testing.assert_allclose(got.A[og], ref.A[orf], rtol=0, atol=a_tol)


@pytest.fixture(scope="module")
def deformed():
    """The synthetic deformed grid (packed [21, npix] f64, RING order) and
    150 sources between the two radii."""
    rng = np.random.default_rng(21)
    npix = int(hp.order2npix(ORDER))
    vec = hp.pix2vec_ring(np.arange(npix, dtype=np.int64), ORDER)
    packed = np.zeros((21, npix))
    tang = rng.normal(size=(3, npix))
    tang -= vec.T * np.einsum("ip,pi->p", tang, vec)
    nvec = vec.T + 1e-3 * tang
    packed[0:3] = nvec / np.linalg.norm(nvec, axis=0, keepdims=True) * WPM1
    packed[3:6] = vec.T
    packed[6] = packed[9] = packed[10] = packed[13] = 1.0
    packed[6] += 1e-2 * rng.normal(size=npix)
    packed[9] += 1e-2 * rng.normal(size=npix)
    gal_pos = _unit(rng, 150) * 0.5 * (WPM1 + WPM2 + 300.0)
    return packed, gal_pos


def test_paratrans_matches_jax():
    rng = np.random.default_rng(3)
    v, r = _unit(rng, 500), _unit(rng, 500)
    v[:3], r[:3] = [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]  # the same point
    T = rng.normal(size=(500, 2, 2))
    t = rng.normal(size=(500, 2))
    ax, c = _unit(rng, 500), rng.uniform(-1, 1, 500)
    s = np.sqrt(1 - c * c)
    tt = (torch.tensor(x) for x in (v, r, T, t, ax, c, s))
    tv, tr, tT, tt_, tax, tc, ts = tt
    for got, ref in (
            (tpt.paratrans_tangtensor(tT, tv, tr),
             jpt.paratrans_tangtensor(T, v, r)),
            (tpt.paratrans_tangvec(tt_, tv * 3.0, tr),
             jpt.paratrans_tangvec(t, v * 3.0, r)),
            (tpt.rotate_axis_angle(tv, tax, tc, ts),
             jpt.rotate_axis_angle(v, ax, c, s)),
            # broadcast [N, 4, 3] against [N, 1, 3], as _interp_A_at
            (tpt.paratrans_tangtensor(tT[:, None].expand(-1, 4, -1, -1),
                                      tv[:, None].expand(-1, 4, -1),
                                      tr[:, None]),
             jpt.paratrans_tangtensor(np.repeat(T[:, None], 4, 1),
                                      np.repeat(v[:, None], 4, 1),
                                      r[:, None]))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("order", [2, 3, 5])
def test_triangles_ring_matches_jax_and_host(order):
    npix = int(hp.order2npix(order))
    got = torchhp.triangles_ring(torchhp.InterpTables(order),
                                 torch.arange(npix))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), hp.build_triangles(order))
    ref = jaxhp.triangles_ring(jaxhp.InterpTables(order),
                               jnp.arange(npix, dtype=jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("order,dt", [(5, np.float64), (7, np.float32)])
def test_ring_window_matches_jax(order, dt):
    """Random directions and the poles; the window of the search's own
    size at this order."""
    v = _unit(np.random.default_rng(order), 2000)
    v[:3] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1e-9, 0.0, -1.0]]
    th, ph = (x.astype(dt) for x in hp.vec2ang(v))
    nr, nc = tgs.search_windows(order)
    assert (nr, nc) == jgs.search_windows(order)
    got = torchhp.ring_window(torchhp.InterpTables(order), torch.tensor(th),
                              torch.tensor(ph), nr, nc)
    ref = jaxhp.ring_window(jaxhp.InterpTables(order, dtype=dt),
                            jnp.asarray(th), jnp.asarray(ph), nr, nc)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _box_rows(ra0, dec0, dra, ddec):
    npix = int(hp.order2npix(ORDER))
    ra, dec = hp.ang2radec(*hp.pix2ang_ring(np.arange(npix), ORDER))
    return np.flatnonzero((np.abs(ra - ra0) < dra)
                          & (np.abs(dec - dec0) < ddec)).astype(np.int64)


@pytest.mark.parametrize("sky", ["full", "box"])
def test_find_images_device_matches_jax(deformed, sky):
    """The device search on the full sky, and with ring_rows on a box's
    rows (sources well inside it)."""
    packed, gal_pos = deformed
    cfg = _cfg()
    rows = None
    if sky == "box":
        rows = _box_rows(40.0, 10.0, 30.0, 25.0)
        packed = packed[:, rows]
        rng = np.random.default_rng(5)
        gal_pos = hp.radec2vec(rng.uniform(25.0, 55.0, 60),
                               rng.uniform(-5.0, 25.0, 60)) * 690.0
    idx = np.arange(len(gal_pos)) * 3
    ref = jgs.find_images_device(
        cfg, jaxhp.InterpTables(ORDER, dtype=jnp.float64),
        jnp.asarray(packed), gal_pos, idx, WPM1, WPM2, chunk=CHUNK,
        ring_rows=rows)
    got = tgs.find_images_device(cfg, torchhp.InterpTables(ORDER),
                                 torch.tensor(packed), gal_pos, idx, WPM1,
                                 WPM2, chunk=CHUNK, ring_rows=rows)
    assert len(got.index) >= len(gal_pos)
    assert_same_images(got, ref)


def _image_distance(got, ref):
    """(max |ra| deg, max |dec| deg, max |A|) between two image sets of
    equal index multisets, rows matched by (index, ra)."""
    assert len(got.index) == len(ref.index)
    og, orf = (np.lexsort((x.ra, x.index)) for x in (got, ref))
    np.testing.assert_array_equal(got.index[og], ref.index[orf])
    dra = np.abs(got.ra[og] - ref.ra[orf])
    dra = np.minimum(dra, 360.0 - dra)
    return (float(dra.max()), float(np.abs(got.dec[og] - ref.dec[orf]).max()),
            float(np.abs(got.A[og] - ref.A[orf]).max()))


def test_float32_device_search_no_farther_from_float64_than_jax(deformed):
    """Both packages' find_images_device on one float32 buffer (the deformed
    grid, its 150 sources and 80 more at |dec| 80-89.9 degrees), each held
    to a float64 search of the same buffer: the same images, and the port
    no farther from float64 than JAX in ra, dec and A.  float32 arccos and
    1 - z make both ~1e-3 degrees off at the poles (ROADMAP Queue 3)."""
    packed, gal_pos = deformed
    rng = np.random.default_rng(80)
    dec = rng.uniform(80.0, 89.9, 80) * rng.choice([-1.0, 1.0], 80)
    polar = hp.radec2vec(rng.uniform(0.0, 360.0, 80), dec) * 690.0
    gal_pos = np.concatenate([gal_pos, polar])
    idx = np.arange(len(gal_pos)) * 3
    cfg = _cfg(Precision="f32")
    p32 = packed.astype(np.float32)
    p64 = p32.astype(np.float64)
    ref = tgs.find_images_device(_cfg(), torchhp.InterpTables(ORDER),
                                 torch.tensor(p64), gal_pos, idx, WPM1,
                                 WPM2, chunk=CHUNK)
    ref_j = jgs.find_images_device(
        _cfg(), jaxhp.InterpTables(ORDER, dtype=jnp.float64),
        jnp.asarray(p64), gal_pos, idx, WPM1, WPM2, chunk=CHUNK)
    assert_same_images(ref, ref_j)
    got = tgs.find_images_device(cfg, torchhp.InterpTables(ORDER),
                                 torch.tensor(p32), gal_pos, idx, WPM1,
                                 WPM2, chunk=CHUNK)
    got_j = jgs.find_images_device(
        cfg, jaxhp.InterpTables(ORDER, dtype=jnp.float32),
        jnp.asarray(p32), gal_pos, idx, WPM1, WPM2, chunk=CHUNK)
    d_port, d_jax = _image_distance(got, ref), _image_distance(got_j, ref)
    print("float32 from float64 (ra, dec, A): port", d_port, "JAX", d_jax)
    assert len(got.index) >= len(gal_pos)
    for what, a, b in zip(("ra", "dec", "A"), d_port, d_jax):
        assert a <= b, f"{what}: port {a:.3e} from float64, JAX {b:.3e}"


@pytest.mark.parametrize("sky", ["full", "box"])
def test_find_images_host_matches_jax(deformed, sky):
    """The host-prep search with nest2index: the full sky's ring_of_nest,
    or a box's NEST pixel -> row map (-1 where no ray is)."""
    packed, gal_pos = deformed
    cfg = _cfg()
    tables = tgs.GridSearchTables(ORDER)
    jtables = jgs.GridSearchTables(ORDER)
    for k in ("nest_of_ring", "ring_of_nest", "tri_nest"):
        np.testing.assert_array_equal(getattr(tables, k),
                                      getattr(jtables, k))
    n2i = tables.ring_of_nest
    if sky == "box":
        rows = _box_rows(200.0, -20.0, 30.0, 25.0)
        packed = packed[:, rows]
        n2i = np.full(len(n2i), -1, np.int64)
        n2i[tables.nest_of_ring[rows]] = np.arange(len(rows))
    got = tgs.find_images(cfg, tables, torch.tensor(packed), gal_pos,
                          np.arange(len(gal_pos)), WPM1, WPM2,
                          nest2index=n2i)
    ref = jgs.find_images(cfg, jtables, jnp.asarray(packed), gal_pos,
                          np.arange(len(gal_pos)), WPM1, WPM2,
                          nest2index=n2i)
    assert len(got.index) >= (len(gal_pos) if sky == "full" else 1)
    assert_same_images(got, ref)


def test_find_images_born_matches_jax(deformed):
    packed, gal_pos = deformed
    cfg = _cfg()
    idx = np.arange(len(gal_pos)) + 7
    got = tgs.find_images_born(cfg, None, torch.tensor(packed), gal_pos,
                               idx, WPM1, WPM2)
    ref = jgs.find_images_born(cfg, None, jnp.asarray(packed), gal_pos, idx,
                               WPM1, WPM2)
    np.testing.assert_array_equal(got.index, ref.index)
    assert_same_images(got, ref)


def _port_trace(tmp, part_mass, planes):
    """A port trace (CPU, f64) at SHTOrder 6 / rayOrder 5 through one point
    mass, stepped through `planes` planes."""
    cfg = RayTraceConfig(
        OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
        LensPlanePath=str(tmp), LensPlaneName="pmplane", SHTOrder=6,
        rayOrder=ORDER, bundleOrder=2, partMass=part_mass, raPointMass=32.0,
        decPointMass=14.0, radPointMass=625.0, PointMassTest=True,
        Precision="f64", ComvSmoothingScale=1.0,
        SmoothingBeamFWHM=0.024).finalize()
    mass_vec, mass_plane = pm.make_pointmass_planes(
        cfg, snap_to_pixel_order=cfg.SHTOrder)
    rt = TRaytracer(cfg, device="cpu")
    rt.init_rays()
    for p in range(planes):
        rt.step(p)
    return cfg, rt, np.asarray(mass_vec), mass_plane


@pytest.fixture(scope="module")
def pm_port_trace(tmp_path_factory):
    """Traced to the plane after the mass (plane 3 of 250-Mpc/h bins)."""
    return _port_trace(tmp_path_factory.mktemp("pm"), 5.0e16, 4)


def test_device_search_on_a_port_trace_matches_jax(pm_port_trace):
    """Sources in the bin of the plane after the mass, all over the sky and
    clustered near the mass, searched on the port's traced rays by both
    packages; then the same rows as a box by both packages' ring_rows
    search."""
    cfg, rt, mass_vec, mass_plane = pm_port_trace
    target = mass_plane + 1
    pp = plane_params(cfg, rt.cosmo, target)
    rng = np.random.default_rng(7)
    g = np.concatenate([_unit(rng, 100), _unit(rng, 60) * 0.15 + mass_vec])
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    gal_pos = g * (target * 250.0 + 125.0)
    packed = rt.rays_packed.numpy()
    ref = jgs.find_images_device(
        cfg, jaxhp.InterpTables(ORDER, dtype=jnp.float64),
        jnp.asarray(packed), gal_pos, np.arange(160), pp.rad,
        pp.rad_minus1, chunk=CHUNK)
    got = tgs.find_images_device(cfg, torchhp.InterpTables(ORDER),
                                 rt.rays_packed, gal_pos, np.arange(160),
                                 pp.rad, pp.rad_minus1, chunk=CHUNK)
    assert len(got.index) >= 160
    assert_same_images(got, ref)


def test_strong_lens_gives_two_or_more_images_as_jax(tmp_path):
    """A super-critical point mass images an offset source two or more
    times, on both sides of the mass: the same images from the port's host
    search (expand 3, as the JAX test) and the JAX package's on the port's
    traced rays.  The device search looks only at the topk pixel centres
    nearest the source, so it finds the images within them, the same ones
    as the JAX package's device search."""
    cfg, rt, mass_vec, mass_plane = _port_trace(tmp_path, 1.6e20, 4)
    pp = plane_params(cfg, rt.cosmo, 4)
    ppl = plane_params(cfg, rt.cosmo, mass_plane)
    w_src = 1100.0
    q = pm.charge(cfg, rt.cosmo, ppl.rad)
    theta_E = np.sqrt((w_src - ppl.rad) / w_src * q / (2.0 * np.pi))
    pix = np.sqrt(4.0 * np.pi / hp.order2npix(ORDER))
    assert theta_E > 3.0 * pix  # resolved by several ray pixels
    e1 = np.cross(mass_vec, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1)
    beta = 0.5 * theta_E
    gal_pos = ((np.cos(beta) * mass_vec + np.sin(beta) * e1) * w_src)[None]
    tables, jtables = (m.GridSearchTables(ORDER, expand=3)
                       for m in (tgs, jgs))
    args = (gal_pos, np.array([7]), pp.rad, pp.rad_minus1)
    host = tgs.find_images(cfg, tables, rt.rays_packed, *args,
                           nest2index=tables.ring_of_nest)
    ref = jgs.find_images(cfg, jtables, rt.rays_packed.numpy(), *args,
                          nest2index=jtables.ring_of_nest)
    assert len(host.index) >= 2, "a strong lens must image twice"
    assert_same_images(host, ref)
    side = np.sign(hp.radec2vec(host.ra, host.dec) @ e1)
    assert side.min() < 0 < side.max()
    dev = tgs.find_images_device(cfg, torchhp.InterpTables(ORDER),
                                 rt.rays_packed, *args, chunk=CHUNK)
    jdev = jgs.find_images_device(
        cfg, jaxhp.InterpTables(ORDER, dtype=jnp.float64),
        jnp.asarray(rt.rays_packed.numpy()), *args, chunk=CHUNK)
    assert len(dev.index) >= 1
    assert_same_images(dev, jdev)


def _fallback_fixture():
    """The undeflected order-5 grid (packed f64, RING order) and 12
    sources: exactly one identity image each."""
    rng = np.random.default_rng(9)
    npix = int(hp.order2npix(ORDER))
    vec = hp.pix2vec_ring(np.arange(npix, dtype=np.int64), ORDER)
    packed = np.zeros((21, npix))
    packed[0:3] = vec.T * WPM1
    packed[3:6] = vec.T
    packed[6] = packed[9] = packed[10] = packed[13] = 1.0
    gal_pos = _unit(rng, 12) * rng.uniform(600.0, 740.0, (12, 1))
    return torch.tensor(packed), gal_pos


def test_collect_overflow_falls_back_to_the_host_search():
    """A chunk whose count overflows its maxh slots (forged, as
    tests/test_gridsearch.py forges it) is searched again by find_images
    on the live pre-step buffer; on the full sky and on a box's rows."""
    packed, gal_pos = _fallback_fixture()
    G, maxh = len(gal_pos), 24
    pend = [(0, (torch.tensor(maxh + 1), torch.zeros(maxh, dtype=torch.long),
                 torch.zeros(maxh), torch.zeros(maxh),
                 torch.zeros(4, maxh)))]
    tab = torchhp.InterpTables(ORDER)
    out = tgs._collect_device_hits(_cfg(), tab, packed, pend, gal_pos,
                                   np.arange(G), WPM1, WPM2, G, maxh)
    assert sorted(out.index) == list(range(G))
    np.testing.assert_allclose(out.A, np.tile(np.eye(2), (G, 1, 1)),
                               rtol=0, atol=1e-10)
    # a box of the rows within 20 degrees of a source: the same images
    # through ring_rows
    vec = hp.pix2vec_ring(np.arange(packed.shape[1]), ORDER)
    gvec = gal_pos / np.linalg.norm(gal_pos, axis=1, keepdims=True)
    rows = np.flatnonzero((vec @ gvec.T).max(axis=1) > np.cos(np.radians(20)))
    assert len(rows) < packed.shape[1]
    sub = tgs._collect_device_hits(_cfg(), tab, packed[:, rows], pend,
                                   gal_pos, np.arange(G), WPM1, WPM2, G,
                                   maxh, ring_rows=rows)
    assert_same_images(sub, out)


def test_async_dispatch_reads_no_hit_count(monkeypatch):
    """find_images_device_async queues the search and returns without
    reading a device value (no .item(), .cpu(), .numpy(), .tolist() or
    Python conversion of a tensor); collect() reads the counts."""
    packed, gal_pos = _fallback_fixture()
    tab = torchhp.InterpTables(ORDER)
    reads = []

    def forbidden(name):
        def read(self, *a, **k):
            reads.append(name)
            raise AssertionError(f"Tensor.{name} during the dispatch")
        return read

    names = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
             "__float__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    for n in names:
        monkeypatch.setattr(torch.Tensor, n, forbidden(n))
    collect = tgs.find_images_device_async(_cfg(), tab, packed, gal_pos,
                                           np.arange(12), WPM1, WPM2,
                                           chunk=5)
    for n, f in saved.items():
        monkeypatch.setattr(torch.Tensor, n, f)
    assert reads == [] and callable(collect)
    out = collect()
    assert sorted(out.index) == list(range(12))


def _gal_run_cfg(tmp, out, **kw):
    base = dict(OmegaM=0.3, maxComvDistance=2000.0, NumLensPlanes=8,
                LensPlanePath=str(tmp), LensPlaneName="pmplane",
                SHTOrder=5, rayOrder=4, bundleOrder=2, partMass=5.0e16,
                raPointMass=32.0, decPointMass=14.0, radPointMass=625.0,
                PointMassTest=True, Precision="f64", OutputPath=str(out),
                GalsFileList=str(tmp / "gals.txt"), GalOutputName="gal_",
                LensMapOrder=4)
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _read_catalogs(out):
    rows = {}
    for f in sorted(os.listdir(out)):
        if f.startswith("gal_"):
            rows[f] = tgio.read_image_gals(os.path.join(out, f))
    return rows


def _as_images(rec):
    return tgs.ImageGals(np.asarray(rec["index"]), np.asarray(rec["ra"]),
                         np.asarray(rec["dec"]), np.stack(
                             [np.asarray(rec[k]) for k in
                              ("A00", "A01", "A10", "A11")], -1
                         ).reshape(-1, 2, 2))


@pytest.fixture(scope="module")
def gal_catalog(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gals")
    rng = np.random.default_rng(23)
    g = _unit(rng, 200) * rng.uniform(300.0, 1900.0, (200, 1))
    tgio.write_source_gals(str(tmp / "cat.fit"), g)
    (tmp / "gals.txt").write_text(str(tmp / "cat.fit") + "\n")
    # the sources of planes 1 and 2 alone: the JAX driver searches each
    # plane in chunks of 16384 padded sources, seconds per plane on the CPU
    near = g[np.linalg.norm(g, axis=1) < 740.0]
    tgio.write_source_gals(str(tmp / "near.fit"), near)
    (tmp / "near.txt").write_text(str(tmp / "near.fit") + "\n")
    pm.make_pointmass_planes(_gal_run_cfg(tmp, tmp / "x"),
                             snap_to_pixel_order=5)
    return tmp


def test_run_with_gals_async_matches_sync(gal_catalog, monkeypatch):
    """Raytracer.run with GalsFileList: the async search (queued before the
    step, collected after) and CALCLENS_GALS_ASYNC=0 write equal
    catalogs, nearly every source imaged."""
    cats = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("CALCLENS_GALS_ASYNC", flag)
        cfg = _gal_run_cfg(gal_catalog, gal_catalog / f"out{flag}",
                           Profile=True)
        rt = TRaytracer(cfg, device="cpu")
        rt.run(progress=False)
        cats[flag] = _read_catalogs(cfg.OutputPath)
        rows = dict(rt.phase_rows)
        assert all(rows[p]["GRIDSEARCH"] > 0 for p in range(1, 8))
    assert sorted(cats["1"]) == sorted(cats["0"]) and len(cats["1"]) == 7
    total = 0
    for f, rec in cats["1"].items():
        assert_same_images(_as_images(rec), _as_images(cats["0"][f]),
                           ang=0.0, a_tol=0.0)
        total += len(rec)
    assert total >= 180


def test_run_catalogs_match_jax_run(gal_catalog):
    """Raytracer.run with galaxies through both packages, the port started
    from the JAX Raytracer's initial state: the same catalog files per
    plane (index multisets equal; ra, dec and A within the trace's own
    distance between the two packages)."""
    near = str(gal_catalog / "near.txt")
    jcfg = _gal_run_cfg(gal_catalog, gal_catalog / "jax", GalsFileList=near)
    jrt = JRaytracer(jcfg)
    jrt.init_rays()
    trt = TRaytracer(_gal_run_cfg(gal_catalog, gal_catalog / "port",
                                  GalsFileList=near), device="cpu")
    trt.load_state(np.asarray(jrt.rays_packed), 0)
    jrt.run(progress=False)
    trt.run(progress=False)
    ref = _read_catalogs(jcfg.OutputPath)
    got = _read_catalogs(trt.cfg.OutputPath)
    assert sorted(got) == sorted(ref) and len(got) == 2
    for f in got:
        assert_same_images(_as_images(got[f]), _as_images(ref[f]),
                           ang=1e-7, a_tol=1e-9)


def test_gals_io_files_match_jax(tmp_path):
    """The source and image catalog writers give JAX's bytes; the readers
    read both packages' files alike; concat's outputs are the same files."""
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(50, 3)) * 500.0
    for m, d in ((tgio, "t"), (jgio, "j")):
        (tmp_path / d).mkdir()
        m.write_source_gals(str(tmp_path / d / "cat1.fit"), pos[:30])
        m.write_source_gals(str(tmp_path / d / "cat2.fit"), pos[30:])
    for name in ("cat1.fit", "cat2.fit"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    lst = tmp_path / "gals.txt"
    lst.write_text(f"{tmp_path / 'j' / 'cat1.fit'}\n"
                   f"{tmp_path / 'j' / 'cat2.fit'}\n")
    for got, ref in zip(tgio.read_source_gals(str(lst)),
                        jgio.read_source_gals(str(lst))):
        np.testing.assert_array_equal(got, ref)

    paths = {}
    for m, d, out in ((tgs, "t", tgio), (jgs, "j", jgio)):
        cfg = _cfg(OutputPath=str(tmp_path / d / "out"), GalOutputName="g_")
        for plane, n in ((2, 30), (5, 25)):
            sel = np.arange(n) + plane
            img = m.ImageGals(sel, sel * 1.5,
                              sel * 0.5 - 30.0,
                              np.tile(np.eye(2), (n, 1, 1)) * 0.9
                              + 1e-3 * sel[:, None, None])
            paths[d, plane] = out.write_image_gals(cfg, img, plane)
    for plane in (2, 5):
        t, j = paths["t", plane], paths["j", plane]
        assert os.path.basename(t) == os.path.basename(j)
        with open(t, "rb") as a, open(j, "rb") as b:
            assert a.read() == b.read()
        got, ref = tgio.read_image_gals(t), jgio.read_image_gals(j)
        assert got.tobytes() == ref.tobytes()

    imgs = tconcat.read_all_images(str(tmp_path / "t" / "out"), "g_", 8)
    jimgs = jconcat.read_all_images(str(tmp_path / "j" / "out"), "g_", 8)
    assert imgs.tobytes() == jimgs.tobytes() and len(imgs) == 55
    outs = tconcat.write_lensed_catalogs(str(lst), imgs,
                                         str(tmp_path / "t" / "lensed"))
    jouts = jconcat.write_lensed_catalogs(str(lst), jimgs,
                                          str(tmp_path / "j" / "lensed"))
    for t, j in zip(outs, jouts):
        assert os.path.basename(t) == os.path.basename(j)
        with open(t, "rb") as a, open(j, "rb") as b:
            assert a.read() == b.read()
    rec = jfits.read_fits(outs[0])[1][1]
    assert len(rec) > 0 and "kappa" in rec.dtype.names


def test_box_host_search_reads_the_box_rows(gal_catalog, monkeypatch):
    """A box run with CALCLENS_GALS_DEVICE=0 takes the host search; the
    port maps each NEST pixel to its row of the box's buffer (-1 where no
    ray is), so its catalogs equal the box's device search.  The JAX driver
    passes the full sky's ring_of_nest there, rows that a box's buffer does
    not have: on a box's rows the JAX host search with that map finds no
    image (a JAX-side difference)."""
    box = dict(minRa=0.0, maxRa=120.0, minDec=-20.0, maxDec=60.0)
    cats = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("CALCLENS_GALS_DEVICE", flag)
        cfg = _gal_run_cfg(gal_catalog, gal_catalog / f"box{flag}",
                           NumLensPlanes=4, **box)
        TRaytracer(cfg, device="cpu").run(progress=False)
        cats[flag] = _read_catalogs(cfg.OutputPath)
    assert sorted(cats["0"]) == sorted(cats["1"]) and cats["1"]
    for f, rec in cats["1"].items():
        assert len(rec) > 0
        assert_same_images(_as_images(cats["0"][f]), _as_images(rec))

    packed, _ = _fallback_fixture()
    rows = _box_rows(40.0, 10.0, 30.0, 25.0)
    gal_pos = hp.radec2vec(np.full(5, 40.0), np.linspace(0.0, 20.0, 5)) * 690
    tables = jgs.GridSearchTables(ORDER, expand=3)
    jax_driver = jgs.find_images(_cfg(), tables, packed.numpy()[:, rows],
                                 gal_pos, np.arange(5), WPM1, WPM2,
                                 nest2index=tables.ring_of_nest)
    assert len(jax_driver.index) == 0


@pytest.mark.parametrize("mode", ["device", "born", "host"])
def test_bench_gals_on_the_cpu(mode, monkeypatch, capsys):
    """tools/bench_gals.py at a small shape with --device cpu: its JSON
    line, every source imaged on the straight rays; without --device cpu
    on a machine with no GPU it fails."""
    import json

    from calclens_tpu_torch.tools import bench_gals

    for k, v in (("BENCH_RAY_ORDER", "4"), ("BENCH_NGALS", "300"),
                 ("BENCH_GALS_CHUNK", "128"), ("BENCH_GALS_MODE", mode)):
        monkeypatch.setenv(k, v)
    assert bench_gals.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "gals_per_sec_gridsearch" and out["mode"] == mode
    assert out["device"] == "cpu" and out["ngals"] == 300
    assert out["images_found"] >= 300 and out["value"] > 0
    if not torch.cuda.is_available():
        assert bench_gals.main([]) == 1
