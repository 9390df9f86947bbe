"""The port's phase split (Profile), its timing files and bench_torch.py, on
the CPU.

The phase-split step runs the fused step's own calls with a sync between
them, so its rays must equal the fused step's bit for bit.  The timing files
are held to a JAX Profile run of the same configuration: the same header
and columns in timing.0, the same tags and counts in timing (the times
themselves are each machine's own).  bench_torch.py prints bench.py's JSON
keys."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from calclens_tpu.config import RayTraceConfig
from calclens_tpu.driver import Raytracer as JRaytracer
from calclens_tpu.testing import pointmass as pm
from calclens_tpu_torch.driver import Raytracer as TRaytracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("DEPOSIT", "SHTSOLVE", "SHT", "RAYPROP")


def _particles(p, n=2000):
    rng = np.random.default_rng(200 + p)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * (150.0 + 250.0 * p), rng.uniform(1e12, 5e13, size=n)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_profiled_step_equals_fused_step_bit_for_bit(dtype):
    base = dict(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
                SHTOrder=5, rayOrder=4, bundleOrder=2, Precision=dtype)
    fused = TRaytracer(RayTraceConfig(**base).finalize(), device="cpu")
    split = TRaytracer(RayTraceConfig(Profile=True, **base).finalize(),
                       device="cpu")
    for rt in (fused, split):
        rt.init_rays()
    for p in (1, 2):
        pos, mass = _particles(p)
        a = fused.step(p, pos=pos, mass=mass, with_maps=True)
        b = split.step(p, pos=pos, mass=mass, with_maps=True)
        assert torch.equal(fused.rays_packed, split.rays_packed), p
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fused.phase_rows == []
    rows = dict(split.phase_rows)
    assert sorted(rows) == [1, 2]
    for p in (1, 2):
        assert sorted(rows[p]) == sorted(PHASES)
        assert all(t > 0 for t in rows[p].values())
        step = dict(split.timings)[p]
        assert sum(rows[p].values()) <= step
    assert split.profiler.count == {k: 2 for k in PHASES}


def _timing_files(rt_cls, tmp, **kw):
    planes = tmp / "planes"
    cfg = RayTraceConfig(
        OmegaM=0.3, maxComvDistance=800.0, NumLensPlanes=3,
        LensPlanePath=str(planes), LensPlaneName="pm", SHTOrder=4,
        rayOrder=3, bundleOrder=1, partMass=1.0e15, raPointMass=40.0,
        decPointMass=10.0, radPointMass=400.0, PointMassTest=True,
        Profile=True, OutputPath=str(tmp / "out")).finalize()
    pm.make_pointmass_planes(cfg)
    os.makedirs(cfg.OutputPath, exist_ok=True)
    rt = rt_cls(cfg, **kw)
    rt.run(progress=False)
    with open(os.path.join(cfg.OutputPath, "timing.0")) as fp:
        t0 = fp.read().splitlines()
    with open(os.path.join(cfg.OutputPath, "timing")) as fp:
        tt = fp.read().splitlines()
    return t0, tt


def test_timing_files_have_the_jax_columns(tmp_path):
    jt0, jtt = _timing_files(JRaytracer, tmp_path / "jax")
    tt0, ttt = _timing_files(TRaytracer, tmp_path / "port", device="cpu")
    assert tt0[0] == jt0[0] == ("# plane StepTime Deposit Shtsolve Sht "
                                "Rayprop Partio Gridsearch Rayio Restart")
    assert len(tt0) == len(jt0) == 4
    for a, b in zip(tt0[1:], jt0[1:]):
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb) == 10
        assert ta[0] == tb[0]
        # the same columns are filled (GridSearch, RayIO, Restart stay 0)
        assert [float(x) > 0 for x in ta[1:]] == [float(x) > 0
                                                  for x in tb[1:]]

    def tags(lines):
        return sorted((ln.split()[0], ln.split()[-1]) for ln in lines if ln)

    assert tags(ttt) == tags(jtt)
    assert {t for t, _ in tags(ttt)} == {*PHASES, "PARTIO"}


def _bench_keys():
    """The keys of the JSON object bench.py prints last."""
    with open(os.path.join(REPO, "bench.py")) as fp:
        tree = ast.parse(fp.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return sorted(k.value for k in node.args[0].keys)
    raise AssertionError("no json.dumps({...}) in bench.py")


def _bench(*args, **env):
    return subprocess.run(
        [sys.executable, "bench_torch.py", *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, **env), capture_output=True,
        text=True, timeout=300)


def test_bench_torch_on_the_cpu_prints_bench_keys():
    res = _bench("--device", "cpu", BENCH_SHT_ORDER="3", BENCH_RAY_ORDER="3",
                 BENCH_NPART="2000")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert sorted(last) == _bench_keys()
    assert last["device"] == "cpu"
    assert last["metric"] == "rays_per_sec_plane_step_nside8"
    assert (last["nrays"], last["npart"]) == (768, 2000)
    assert last["value"] > 0 and last["per_plane_s"] > 0
    phases = json.loads(lines[-2])
    assert phases["profile_plane"] == 5
    assert all(phases[k.lower() + "_s"] > 0 for k in PHASES)


@pytest.mark.parametrize("deposit", ["CIC", "SPH"])
def test_bench_torch_runs_each_deposit_on_the_cpu(deposit):
    """BENCH_DEPOSIT=CIC / SPH: bench.py's keys, with the metric name
    bench.py gives the scheme (rays_per_sec_plane_step_<scheme>_nside<N>),
    and the Profile'd plane's phase row."""
    res = _bench("--device", "cpu", BENCH_SHT_ORDER="3", BENCH_RAY_ORDER="3",
                 BENCH_NPART="2000", BENCH_DEPOSIT=deposit)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert sorted(last) == _bench_keys()
    assert last["metric"] == \
        f"rays_per_sec_plane_step_{deposit.lower()}_nside8"
    assert last["device"] == "cpu" and last["nrays"] == 768
    assert last["value"] > 0 and last["per_plane_s"] > 0
    phases = json.loads(lines[-2])
    assert all(phases[k.lower() + "_s"] > 0 for k in PHASES)


def test_bench_torch_runs_the_mg_mode_on_the_cpu():
    """BENCH_MODE=MG at a tiny shape (SHTOrder 3, rayOrder 4, bundleOrder 1;
    the driver's 130^2 patches): bench.py's keys and metric name
    (rays_per_sec_plane_step_mg_nside8, _cic_ under BENCH_DEPOSIT=CIC), the
    Profile'd plane's row with the MG parts and its 10 V-cycles."""
    for deposit, tag in (("NGP", "mg"), ("CIC", "cic")):
        # one OpenMP thread: the suite's parallel workers would
        # oversubscribe the cores with the patch solve's thread pools
        res = _bench("--device", "cpu", BENCH_MODE="MG", BENCH_SHT_ORDER="3",
                     BENCH_RAY_ORDER="4", BENCH_BUNDLE_ORDER="1",
                     BENCH_NPART="2000", BENCH_DEPOSIT=deposit,
                     OMP_NUM_THREADS="1")
        assert res.returncode == 0, res.stderr
        lines = res.stdout.strip().splitlines()
        last = json.loads(lines[-1])
        assert sorted(last) == _bench_keys()
        assert last["metric"] == f"rays_per_sec_plane_step_{tag}_nside8"
        assert last["device"] == "cpu" and last["nrays"] == 3072
        assert last["value"] > 0 and last["per_plane_s"] > 0
        phases = json.loads(lines[-2])
        assert phases["mg_cycles"] == 10
        assert all(phases[k.lower() + "_s"] > 0 for k in PHASES + (
            "MGDEPOSIT", "MGBC", "MGSOLVE", "MGINTERP"))


def test_bench_torch_refuses_what_it_cannot_run(monkeypatch):
    import bench_torch

    if not torch.cuda.is_available():
        res = _bench(BENCH_SHT_ORDER="3", BENCH_RAY_ORDER="3")
        assert res.returncode != 0 and not res.stdout.strip()
        assert "no CUDA device" in res.stderr
    monkeypatch.setenv("BENCH_MODE", "THREEDPOT")
    with pytest.raises(ValueError, match="BENCH_MODE=THREEDPOT"):
        bench_torch.main(["--device", "cpu"])
    monkeypatch.setenv("BENCH_MODE", "SHT")
    monkeypatch.setenv("BENCH_DEPOSIT", "TSC")
    with pytest.raises(ValueError, match="BENCH_DEPOSIT=TSC"):
        bench_torch.main(["--device", "cpu"])
