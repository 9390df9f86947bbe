"""The port's lightcone readers and lens-plane maker
(calclens_tpu_torch/io/lightcone.py, lensplane_maker.py, io/lensplanes.py):
tests/test_lightcone_readers.py's four checks through the port, and the
plane files the port makes from each format equal, array for array, to the
JAX package's from the same files."""
import numpy as np
import pytest

from calclens_tpu.io import lightcone as jlc
from calclens_tpu.lensplane_maker import make_lensplanes as jmake
from calclens_tpu_torch.io import lgadget
from calclens_tpu_torch.io import lightcone as lc
from calclens_tpu_torch.io.lensplanes import plane_filename, read_plane
from calclens_tpu_torch.lensplane_maker import make_lensplanes


def _particles(n=5000, rmax=900.0, seed=7):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = rmax * rng.uniform(0.05, 1.0, n) ** (1 / 3)
    return v * r[:, None]


def _same_planes(tmp_path, name, num_planes):
    """Every dataset of the port's plane files equals the JAX package's."""
    import h5py

    for p in range(num_planes):
        with h5py.File(plane_filename(str(tmp_path / "planes"), name, p),
                       "r") as ft, \
                h5py.File(plane_filename(str(tmp_path / "jplanes"), name, p),
                          "r") as fj:
            assert sorted(ft.keys()) == sorted(fj.keys())
            for key in fj.keys():
                np.testing.assert_array_equal(np.asarray(ft[key]),
                                              np.asarray(fj[key]))


def test_gadget2_roundtrip(tmp_path):
    pos = _particles()
    fn = str(tmp_path / "lc_g2.0")
    # two particle types with different masses; code units = kpc/h and
    # 1e10 Msun/h so the conv factors are exercised
    n0 = 1200
    lc.write_gadget2(fn, pos * 1000.0, time=0.5,
                     npart_by_type=(n0, len(pos) - n0, 0, 0, 0, 0),
                     mass_by_type=(2.0, 1.0, 0, 0, 0, 0))
    rpos, rvel, rmass, hd = lc.read_gadget2(fn)
    np.testing.assert_allclose(rpos, pos * 1000.0, rtol=1e-6)
    assert hd["time"] == 0.5
    np.testing.assert_array_equal(rmass[:n0], 2.0)
    np.testing.assert_array_equal(rmass[n0:], 1.0)

    kw = dict(num_planes=4, max_comv_distance=1000.0, lens_plane_order=2)
    counts = make_lensplanes(
        lc.lightcone_chunks("GADGET2", [fn], mass_conv=1e10,
                            length_conv=1e-3, chunk=1024),
        str(tmp_path / "planes"), "g2", **kw)
    assert sum(counts) == len(pos)
    got_pos, got_mass = [], []
    for p in range(4):
        pp, mm = read_plane(plane_filename(str(tmp_path / "planes"), "g2", p))
        got_pos.append(pp), got_mass.append(mm)
    got_pos = np.concatenate(got_pos)
    got_mass = np.concatenate(got_mass)
    assert len(got_pos) == len(pos)
    # f32 positions: compare against the f32-quantized originals
    order_a = np.lexsort(np.asarray(got_pos, np.float32).T)
    ref32 = (pos * 1000.0).astype(np.float32).astype(np.float64) * 1e-3
    order_b = np.lexsort(np.asarray(ref32, np.float32).T)
    np.testing.assert_allclose(got_pos[order_a], ref32[order_b], rtol=1e-5)
    assert set(np.unique(got_mass)) == {1e10, 2e10}
    assert jmake(jlc.lightcone_chunks("GADGET2", [fn], mass_conv=1e10,
                                      length_conv=1e-3, chunk=1024),
                 str(tmp_path / "jplanes"), "g2", **kw) == counts
    _same_planes(tmp_path, "g2", 4)


def test_artlc_roundtrip(tmp_path):
    pos = _particles(n=3000, seed=9)
    vel = np.random.default_rng(1).normal(size=pos.shape)
    fn = str(tmp_path / "lc_art.0")
    lc.write_artlc(fn, pos, vel=vel, partid=np.arange(3000) * 3)
    pid, rpos, rvel = lc.read_artlc(fn)
    np.testing.assert_array_equal(pid, np.arange(3000) * 3)
    np.testing.assert_allclose(rpos, pos.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(rvel, vel.astype(np.float32), rtol=1e-6)

    kw = dict(num_planes=4, max_comv_distance=1000.0, lens_plane_order=2)
    counts = make_lensplanes(lc.lightcone_chunks("ARTLC", [fn],
                                                 part_mass=4.2e11),
                             str(tmp_path / "planes"), "art", **kw)
    assert sum(counts) == 3000
    _, mm = read_plane(plane_filename(str(tmp_path / "planes"), "art", 1))
    assert np.all(mm == np.float32(4.2e11))
    assert jmake(jlc.lightcone_chunks("ARTLC", [fn], part_mass=4.2e11),
                 str(tmp_path / "jplanes"), "art", **kw) == counts
    _same_planes(tmp_path, "art", 4)


def test_lgadget_dispatch(tmp_path):
    pos = _particles(n=2000, seed=11)
    fn = str(tmp_path / "lc_lg.0")
    lgadget.write_snapshot(fn, pos, mass1_1e10=3.0)
    total = 0
    for p, m in lc.lightcone_chunks("LGADGET", [fn]):
        total += len(p)
        assert np.all(m == 3e10)
    assert total == 2000
    got = list(lc.lightcone_chunks("LGADGET", [fn], mass_conv=0.5,
                                   length_conv=2.0, chunk=700))
    ref = list(jlc.lightcone_chunks("LGADGET", [fn], mass_conv=0.5,
                                    length_conv=2.0, chunk=700))
    assert len(got) == len(ref) == 3
    for (gp, gm), (rp, rm) in zip(got, ref):
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(gm, rm)


def test_unknown_type_raises():
    with pytest.raises(ValueError):
        lc.lightcone_chunks("NOPE", [])
