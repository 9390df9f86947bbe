"""The port's own copies of the JAX package's host modules against the
originals on the same inputs: config, cosmology, healpix.core (the part the
port calls), and the io readers (FITS ring weights and pixel windows,
pixLC and HDF5 lens planes) on files written by the JAX package's writers.
The copies run the same numpy code, so every result must be equal."""
import dataclasses

import numpy as np
import pytest

from calclens_tpu import config as jconfig
from calclens_tpu import cosmology as jcosmo
from calclens_tpu.healpix import core as jhp
from calclens_tpu.io import fits as jfits
from calclens_tpu.io import lensplanes as jlens
from calclens_tpu.io import pixlc as jpixlc
from calclens_tpu.io import weights as jweights
from calclens_tpu_torch import config as tconfig
from calclens_tpu_torch import cosmology as tcosmo
from calclens_tpu_torch.healpix import core as thp
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
