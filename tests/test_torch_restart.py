"""The port's sharded checkpoint (calclens_tpu_torch/restart.py
write_restart_sharded / read_restart_sharded; Raytracer.save_restart_sharded
/ load_restart_sharded; what run() and the CLI write and resume), the
counterpart of the JAX package's orbax checkpoint.

In one process: written as 1, 2 and 3 blocks of uneven bounds and read as
1-4 blocks of other bounds, equal bits, with and without a nest index;
the cast to a reader's dtype equal to read_restart's; a mismatched config,
an unfinished write (.tmp, a directory without meta.json, a missing
shard) refused; the previous checkpoint kept as .bak.  Through the drivers,
after tests/test_orbax_restart.py::test_orbax_elastic_resume_across_device_counts
(f64, SHTOrder 5, rayOrder 5, the same 4096 seeded points): planes 0-2,
the checkpoint, planes 2-4 in a new Raytracer, against the JAX package's
straight-through trace (that test's rtol 1e-12; its atol 1e-13 taken as
1e-12 of each quantity's max, see the test) and the port's own (equal
bits); the checkpoint carried to JAX through the npz restart (equal
bits); a cut-sky run's nest and vacuum mask restored.  The
multi-rank resumes (1 -> 2, 2 -> 1, 2 -> 4 gloo ranks) are in
tests/test_torch_multichip.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from calclens_tpu.config import RayTraceConfig
from calclens_tpu import driver as jdriver
from calclens_tpu_torch import driver as tdriver
from calclens_tpu_torch import restart as rst
from calclens_tpu_torch.parallel.sharding import block_bounds
from calclens_tpu_torch.raytrace import main as port_main

N = 3072  # rayOrder 4
# the packed rows of each quantity: n, beta, A, Aprev, alpha, U, phi
GROUPS = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20), (20, 21))
WRITERS = {1: [0, N], 2: [0, 1234, N], 3: [0, 7, 2000, N]}


def _cfg(**kw):
    base = dict(OmegaM=0.3, maxComvDistance=1000.0, NumLensPlanes=4,
                rayOrder=4, bundleOrder=2, SHTOrder=4)
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(21, N)), rng.permutation(N).astype(np.int64)


def _write(path, cfg, packed, nest, bounds, plane=3, map_num=1):
    """Every rank's part in one process: rank 0, which commits, last."""
    for r in reversed(range(len(bounds) - 1)):
        a, b = bounds[r], bounds[r + 1]
        rst.write_restart_sharded(path, cfg, torch.from_numpy(packed[:, a:b]),
                                  None if nest is None else nest[a:b], plane,
                                  map_num, bounds, r)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("with_nest", [False, True])
@pytest.mark.parametrize("writers", sorted(WRITERS))
def test_any_split_reads_back_the_same_bits(tmp_path, monkeypatch, writers,
                                            with_nest):
    """Written as `writers` blocks, read as 1, 2, 3 and 4 blocks whose
    bounds are not the writers' (and a block inside one shard), through a
    staging buffer smaller than a row: each reader's columns equal bits,
    the whole nest (or None on the full sky), the plane and map number."""
    monkeypatch.setattr(rst, "STAGING_BYTES", 1000)
    cfg = _cfg()
    packed, nest = _state()
    nest = nest if with_nest else None
    path = str(tmp_path / "ck")
    _write(path, cfg, packed, nest, WRITERS[writers])
    meta = json.loads((tmp_path / "ck" / rst.META).read_text())
    assert meta["bounds"] == WRITERS[writers] and meta["nest"] == with_nest
    assert len(os.listdir(path)) == 1 + writers * (1 + with_nest)
    splits = [block_bounds(N, k) for k in (1, 2, 3, 4)] + [[1300, 1900]]
    for bounds in splits:
        for a, b in zip(bounds[:-1], bounds[1:]):
            got, gnest, plane, map_num = rst.read_restart_sharded(
                path, cfg, lambda n: (a, b), np.float64)
            assert got.dtype == torch.float64 and got.shape == (21, b - a)
            np.testing.assert_array_equal(got.numpy(), packed[:, a:b])
            assert (plane, map_num) == (3, 1)
            if with_nest:
                np.testing.assert_array_equal(gnest, nest)
            else:
                assert gnest is None


def test_read_casts_as_read_restart(tmp_path):
    """A float64 checkpoint read as float32 gives read_restart's float32
    bits of the same state."""
    cfg = _cfg()
    packed, nest = _state(1)
    _write(str(tmp_path / "ck"), cfg, packed, nest, WRITERS[2])
    got = rst.read_restart_sharded(str(tmp_path / "ck"), cfg,
                                   dtype=np.float32)[0]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), packed.astype(np.float32))
    from calclens_tpu_torch.rays import soa

    rst.write_restart(str(tmp_path / "r.npz"), cfg, soa.unpack(packed), nest,
                      3, 1)
    rays = rst.read_restart(str(tmp_path / "r.npz"), cfg, np.float32)[0]
    np.testing.assert_array_equal(
        soa.pack(type(rays)(*map(torch.from_numpy, rays))).numpy(),
        got.numpy())


def test_mismatched_config_is_refused(tmp_path):
    cfg = _cfg()
    packed, _ = _state()
    _write(str(tmp_path / "ck"), cfg, packed, None, WRITERS[1])
    with pytest.raises(ValueError, match=r"\['rayOrder', 'SHTOrder'\]"):
        rst.read_restart_sharded(str(tmp_path / "ck"),
                                 _cfg(rayOrder=5, SHTOrder=5))


def test_previous_checkpoint_kept_as_bak(tmp_path):
    """A second write moves the first to .bak (an older .bak dropped) and
    leaves no .tmp; the reader reads the new one."""
    cfg = _cfg()
    path = str(tmp_path / "ck")
    for plane in (1, 2, 3):
        packed, _ = _state(plane)
        _write(path, cfg, packed, None, WRITERS[plane], plane=plane)
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.bak"]
    assert rst.read_restart_sharded(path, cfg)[2] == 3
    old = rst.read_restart_sharded(path + ".bak", cfg, dtype=np.float64)
    assert old[2] == 2
    np.testing.assert_array_equal(old[0].numpy(), _state(2)[0])


def test_unfinished_writes_are_refused(tmp_path):
    """A .tmp directory, a directory without meta.json and a commit with a
    shard missing each raise an error naming the path; a stale .tmp left
    by an interrupted write is cleaned by the next write."""
    cfg = _cfg()
    packed, _ = _state()
    path = str(tmp_path / "ck")
    b = WRITERS[2]
    rst.write_restart_sharded(path, cfg, torch.from_numpy(packed[:, b[1]:]),
                              None, 3, 1, b, 1)
    assert os.listdir(tmp_path) == ["ck.tmp"]
    with pytest.raises(ValueError, match="ck.tmp is an unfinished"):
        rst.read_restart_sharded(path + ".tmp", cfg)
    with pytest.raises(FileNotFoundError, match="no sharded checkpoint"):
        rst.read_restart_sharded(path, cfg)
    # rank 0 without rank 1's shard: refused, nothing committed
    os.remove(os.path.join(path + ".tmp", "rays.00001.npy"))
    with pytest.raises(OSError, match="not committed"):
        rst.write_restart_sharded(path, cfg,
                                  torch.from_numpy(packed[:, :b[1]]), None,
                                  3, 1, b, 0)
    assert not os.path.exists(path)
    # a stale shard of a larger write and a stale meta.json are dropped
    for fn in ("rays.00007.npy", rst.META):
        (tmp_path / "ck.tmp" / fn).write_text("stale")
    _write(path, cfg, packed, None, b)
    assert sorted(os.listdir(path)) == ["meta.json", "rays.00000.npy",
                                        "rays.00001.npy"]
    os.remove(os.path.join(path, rst.META))
    with pytest.raises(ValueError, match="holds no meta.json"):
        rst.read_restart_sharded(path, cfg)


# ---------------------------------------------------------------------------
# through the drivers
# ---------------------------------------------------------------------------

def _points():
    rng = np.random.default_rng(17)
    v = rng.normal(size=(4096, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v, np.full(4096, 5.0e15)


def _planes(rt, lo, hi):
    v, mass = _points()
    for p in range(lo, hi):
        rt.step(p, pos=v * (125.0 + 250.0 * p), mass=mass)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """test_orbax_elastic_resume_across_device_counts' configuration: the
    JAX package's straight-through single-device trace over planes 0-4
    from its init_rays; the port's from the same state; the port's planes
    0-2, its sharded checkpoint, and planes 2-4 in a new Raytracer."""
    tmp = tmp_path_factory.mktemp("sharded")
    cfg = _cfg(SHTOrder=5, rayOrder=5, Precision="f64")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jrt = jdriver.Raytracer(cfg)
        jrt.init_rays()
        start = np.array(jrt.rays_packed)
        _planes(jrt, 0, 4)
        ref = np.asarray(jrt.rays_packed)
        own = tdriver.Raytracer(cfg, device="cpu")
        own.load_state(start, 0)
        _planes(own, 0, 4)
        first = tdriver.Raytracer(cfg, device="cpu")
        first.load_state(start, 0)
        _planes(first, 0, 2)
        path = str(tmp / "restart_sharded")
        first.save_restart_sharded(path)
        rt = tdriver.Raytracer(cfg, device="cpu")
        rt.load_restart_sharded(path)
        loaded = (rt.current_plane, rt._ray_nest, rt.ray_bounds.tolist(),
                  torch.equal(rt.rays_packed, first.rays_packed))
        _planes(rt, 2, 4)
    finally:
        torch.set_num_threads(threads)
    return dict(cfg=cfg, ref=ref, own=own.rays_packed.numpy(), rt=rt,
                path=path, loaded=loaded, at_two=first.rays_packed, tmp=tmp)


def test_resumed_trace_matches_jax_and_the_straight_run(resumed):
    """The resumed trace equals the port's straight-through trace bit for
    bit, and matches the JAX package's at rtol 1e-12, atol 1e-12 of each
    quantity's max |value|.  The JAX test's atol 1e-13 is absolute, for the
    JAX driver against itself; the port's straight-through trace is 1.4e-12
    off JAX's on A's and Aprev's diagonal of one ray from plane 2 (4 of
    258,048 values, |A| ~ 1: the two SHT solves' U agree within 1e-13 of
    its max and the ray side amplifies that), with or without the
    checkpoint."""
    r = resumed
    plane, nest, bounds, equal = r["loaded"]
    assert plane == 2 and nest is None and bounds == [0, 12 * 4**5] and equal
    got = r["rt"].rays_packed.numpy()
    np.testing.assert_array_equal(got, r["own"])
    for a, b in GROUPS:
        ref = r["ref"][a:b]
        np.testing.assert_allclose(got[a:b], ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())


def test_checkpoint_crosses_to_jax_through_npz(resumed):
    """load_restart_sharded on one device, save_restart (npz), the JAX
    driver's load_restart: equal bits, the same plane."""
    r = resumed
    rt = tdriver.Raytracer(r["cfg"], device="cpu")
    rt.load_restart_sharded(r["path"])
    npz = str(r["tmp"] / "restart.npz")
    rt.save_restart(npz)
    jrt = jdriver.Raytracer(r["cfg"])
    jrt.load_restart(npz)
    assert jrt.current_plane == 2
    np.testing.assert_array_equal(np.asarray(jrt.rays_packed),
                                  r["at_two"].numpy())


def test_cut_sky_checkpoint_restores_the_box(tmp_path, one_thread):
    """A CIC box run's checkpoint after plane 0 resumes in a new Raytracer
    (its vacuum mask built with it) with the box's nest and rays, and plane
    1 gives the straight run's bits."""
    cfg = _cfg(SHTOrder=5, rayOrder=4, Precision="f64", DepositScheme="CIC",
               minRa=0.0, maxRa=90.0, minDec=0.0, maxDec=90.0)
    v, mass = _points()
    rt = tdriver.Raytracer(cfg, device="cpu")
    rt.init_rays()
    rt.step(0, pos=v * 125.0, mass=mass)
    rt.save_restart_sharded(str(tmp_path / "ck"))
    back = tdriver.Raytracer(cfg, device="cpu")
    back.load_restart_sharded(str(tmp_path / "ck"))
    assert back.current_plane == 1 and back.vacmask is not None
    np.testing.assert_array_equal(back.ray_nest, rt.ray_nest)
    assert len(back.ray_nest) < 12 * 4**4
    assert torch.equal(back.rays_packed, rt.rays_packed)
    for t in (rt, back):
        t.step(1, pos=v * 375.0, mass=mass)
    assert torch.equal(back.rays_packed, rt.rays_packed)


def test_cli_never_resumes_from_an_unfinished_write(tmp_path, capsys):
    """A restart_sharded.tmp/ (with a stale meta.json) beside no
    checkpoint: the CLI starts new rays and its run() writes
    restart_sharded/ at the last plane."""
    from calclens_tpu.testing import pointmass as pm

    out = tmp_path / "out"
    cfg = RayTraceConfig(
        OmegaM=0.3, maxComvDistance=800.0, NumLensPlanes=3,
        LensPlanePath=str(tmp_path / "planes"), LensPlaneName="pm",
        SHTOrder=3, rayOrder=3, bundleOrder=1, partMass=1.0e15,
        raPointMass=40.0, decPointMass=10.0, radPointMass=400.0,
        PointMassTest=True, OutputPath=str(out)).finalize()
    pm.make_pointmass_planes(cfg)
    (out / "restart_sharded.tmp").mkdir(parents=True)
    (out / "restart_sharded.tmp" / rst.META).write_text(json.dumps(
        dict(compat=rst._compat(cfg), current_plane=2, map_num=0,
             columns=768, bounds=[0, 768], dtype="<f4", nest=False)))
    path = tmp_path / "raytrace.cfg"
    path.write_text(cfg.to_cfg())
    assert port_main([str(path), "--device", "cpu"]) == 0
    assert "resuming" not in capsys.readouterr().err
    names = os.listdir(out)
    assert "restart_sharded" in names and "restart_sharded.tmp" not in names
    assert rst.read_restart_sharded(str(out / "restart_sharded"),
                                    cfg)[2] == 3


def test_bench_restart_runs_on_the_cpu(tmp_path, capsys):
    """tools/bench_restart.py at rayOrder 4 on the CPU: each route measured
    (the card's fields null), each load checked by the tool, the files
    removed."""
    from calclens_tpu_torch.tools import bench_restart

    assert bench_restart.main(["--device", "cpu", "--ray-order", "4",
                               "--dir", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["metric"] == "restart_routes" and res["bytes"] == 21 * 4 * N
    for key in bench_restart.ROUTES:
        assert res[key]["s"] > 0 and res[key]["card_peak"] is None
    assert res["disk"]["sharded"] > res["bytes"]
    assert os.listdir(tmp_path) == []
