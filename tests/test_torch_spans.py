"""The plane step's spans and counters (calclens_tpu_torch/utils/profile.py).

Under torch.profiler each Raytracer.step logs PLANE > {its phases (the
ring stages RINGS inside them), SYNC} with host times on the profiler's
clock and, on the card, CUDA-event extents; off the profiler nothing is
logged and span() is one shared no-op.  The rays are bit-equal with the
profiler on and off.  The last test runs on the card: the host_sync
counter against the profiler's blocking runtime calls, and the phases'
device extents.  No JAX here: the card runs this file with --noconftest.
"""

import json

import numpy as np
import pytest
import torch

from calclens_tpu_torch import mgdriver
from calclens_tpu_torch.config import RayTraceConfig
from calclens_tpu_torch.driver import Raytracer
from calclens_tpu_torch.ops import deposit as dep
from calclens_tpu_torch.utils import profile as P

PHASES = ("DEPOSIT", "SHTSOLVE", "SHT", "RAYPROP")
# runtime calls in which the host waits for the device
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def _cfg(dtype="f32", **kw):
    base = dict(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
                SHTOrder=5, rayOrder=4, bundleOrder=2, Precision=dtype)
    base.update(kw)
    return RayTraceConfig(**base).finalize()


def _particles(p, n=2000):
    rng = np.random.default_rng(300 + p)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * (150.0 + 250.0 * p), rng.uniform(1e12, 5e13, size=n)


def _raytracer(cfg, device="cpu"):
    rt = Raytracer(cfg, device=device)
    if not cfg.SHTOnly:
        rt.mgsetup = mgdriver.MGSetup(cfg.bundleOrder, 16, cfg.rayOrder,
                                      dtype=rt.dtype)
    rt.init_rays()
    return rt


def _profiled(fn, device="cpu"):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof


def _warm_profiler():
    """The profiler's first record_function, in a process and in each
    profile, takes 0.05-1 ms to enter: made here, before the spans that
    are timed."""
    for _ in range(3):
        with torch.profiler.record_function("warm"):
            pass


@pytest.mark.parametrize("cfg", [
    pytest.param(dict(dtype="f32"), id="sht_f32"),
    pytest.param(dict(dtype="f64"), id="sht_f64"),
    pytest.param(dict(dtype="f64", SHTOnly=False, SHTOrder=4, rayOrder=5),
                 id="mg")])
def test_rays_bit_equal_with_the_profiler_on_and_off(cfg):
    planes = (1,) if "SHTOnly" in cfg else (1, 2)
    plain = _raytracer(_cfg(**cfg))
    traced = _raytracer(_cfg(**cfg))

    def steps(rt):
        for p in planes:
            rt.step(p, *_particles(p))

    steps(plain)
    _profiled(lambda: steps(traced))
    assert torch.equal(plain.rays_packed, traced.rays_packed)
    log = P.take()
    assert [s.name for s in log].count("PLANE") == len(planes)
    if "SHTOnly" in cfg:
        names = {s.name for s in log}
        assert {"MGDEPOSIT", "MGBC", "MGSOLVE", "MGINTERP"} <= names


def test_span_tree_of_one_plane():
    rt = _raytracer(_cfg())
    rt.step(1, *_particles(1))           # builds the plan's tables
    P.take()
    _profiled(lambda: rt.step(2, *_particles(2)))
    log = P.take()
    assert log[0].name == "PLANE" and log[0].parent == -1
    kids = [s.name for s in log if s.parent == 0]
    assert kids == list(PHASES) + ["SYNC"]
    under = {k: [s.name for s in log if s.parent >= 0
                 and log[s.parent].name == k] for k in PHASES + ("SYNC",)}
    assert under == {"DEPOSIT": [], "SHTSOLVE": ["RINGS"],
                     "SHT": ["RINGS"] * 3, "RAYPROP": [], "SYNC": []}
    for s in log:
        assert s.host[0] <= s.host[1]
        assert s.device is None                   # no events on the CPU
        if s.parent >= 0:
            p = log[s.parent]
            assert p.host[0] <= s.host[0] <= s.host[1] <= p.host[1]
    # plane_scalars' 5 copies, add_at's 3, the streams' 2 copies, SYNC
    assert log[0].counts == {"host_sync": 11}
    assert all(s.counts is None for s in log[1:])


def test_no_profiler_nothing_logged():
    rt = _raytracer(_cfg())
    P.take()
    rt.step(1, *_particles(1))
    assert P.take() == []
    assert P.span("SHT") is P.NOOP
    assert P.plane_span("cpu") is P.NOOP
    P.count("host_sync")
    with P.span("DEPOSIT"):
        P.count("host_sync")
    assert P.take() == []


def test_span_edges_on_the_trace_clock(tmp_path):
    """Each span's host edges lie within 50 us of its record_function
    event in the exported chrome trace (ts + the exporter's base).  Three
    planes: each span is held to its best of the three, since a test
    process descheduled between the profiler's stamp and the span's own
    clock reading moves one reading by milliseconds."""
    rt = _raytracer(_cfg())
    rt.step(1, *_particles(1))
    P.take()

    def steps():
        _warm_profiler()
        for p in (2, 3, 4):
            rt.step(p, *_particles(p))

    prof = _profiled(steps)
    log = P.take()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        data = json.load(fp)
    base = int(data.get("baseTimeNanoseconds", 0))
    events = sorted((e for e in data["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e.get("name") != "warm"), key=lambda e: float(e["ts"]))
    assert [e["name"] for e in events] == [s.name for s in log]
    per_plane = len(log) // 3
    for k in range(per_plane):
        err0, err1 = [], []
        for i in range(k, len(log), per_plane):
            t0 = float(events[i]["ts"]) * 1e3 + base
            t1 = t0 + float(events[i]["dur"]) * 1e3
            err0.append(abs(log[i].host[0] - t0))
            err1.append(abs(log[i].host[1] - t1))
        assert min(err0) < 50e3, (log[k].name, err0)
        assert min(err1) < 50e3, (log[k].name, err1)


def test_host_sync_counts_add_at_per_ngp_deposit():
    """add_at waits for the card three times (unique_consecutive's output
    size, segment_reduce's two checks of the lengths): one deposit counts
    3, two count 6."""
    pos, mass = _particles(1)
    pos = torch.as_tensor(pos)
    mass = torch.as_tensor(mass)
    P.take()

    def deposits():
        for k in range(3):
            with P.plane_span("cpu"):
                for _ in range(k):
                    dep.deposit_ngp(4, pos, mass, 3072)

    _profiled(deposits)
    log = P.take()
    assert [s.counts.get("host_sync", 0) for s in log] == [0, 3, 6]


def _blocking_per_plane(events, planes):
    """The blocking runtime calls that start inside each PLANE event."""
    out = []
    for p in planes:
        a, b = float(p["ts"]), float(p["ts"]) + float(p["dur"])
        out.append(sum(1 for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and e.get("name") in BLOCKING
                       and a <= float(e["ts"]) <= b))
    return out


CARD_CASES = {
    "fullsky": dict(SHTOrder=8, rayOrder=8, bundleOrder=3),
    "box": dict(SHTOrder=8, rayOrder=9, bundleOrder=3, minRa=10.0,
                maxRa=40.0, minDec=-10.0, maxDec=20.0),
    "streamed": dict(SHTOrder=8, rayOrder=8, bundleOrder=3),
    "mg": dict(SHTOrder=7, rayOrder=9, bundleOrder=3, SHTOnly=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_counters_and_extents_on_the_card(tmp_path, case):
    """host_sync counts every blocking runtime call the profiler sees in
    each plane; every span's CUDA-event extent is positive and the
    PLANE's children follow each other on the device without overlap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rt = _raytracer(_cfg(**CARD_CASES[case]), device="cuda")
    if case == "streamed":
        rt.plan.synth_stream = 4
    parts = [rt.stage_particles(*_particles(p, 100000)) for p in (1, 2, 3)]
    rt.step(1, *parts[0])
    torch.cuda.synchronize()
    P.take()

    def steps():
        for p in (2, 3):
            rt.step(p, *parts[p - 1])

    prof = _profiled(steps, "cuda")
    log = P.take()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    planes = sorted((e for e in events if e.get("name") == "PLANE"
                     and e.get("cat") == "user_annotation"),
                    key=lambda e: float(e["ts"]))
    counted = [s.counts["host_sync"] for s in log if s.name == "PLANE"]
    assert counted == _blocking_per_plane(events, planes)
    for s in log:
        assert s.device is not None and s.device[1] > s.device[0], s.name
    for i in [i for i, s in enumerate(log) if s.name == "PLANE"]:
        kids = [s for s in log if s.parent == i]
        assert kids[-1].name == "SYNC"
        if case != "mg":
            assert [s.name for s in kids] == list(PHASES) + ["SYNC"]
        for a, b in zip(kids, kids[1:]):
            assert a.device[1] <= b.device[0], (a.name, b.name)
