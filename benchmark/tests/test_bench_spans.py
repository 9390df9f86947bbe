"""The readers of the program's span log on the tiny traced CPU run: the
host and counter metrics report, the device ones (CUDA events, the device
trace) report nothing off the card; the idle split on a made-up trace."""

from collections import namedtuple

import pytest

from bench_tiny import make_root, run_tiny

from benchmark import spans
from benchmark.tracing import Trace

# the fields of the program's profile.SpanRecord
SpanRecord = namedtuple("SpanRecord", "name parent host device counts")

DEVICE = ("deposit_dev_s", "shtsolve_dev_s", "sht_dev_s", "rayprop_dev_s",
          "ringstage_dev_s", "phase_idle_s", "driver_idle_s",
          "device_allocs_per_plane")
HOST = ("driver_self_s", "host_syncs_per_plane")


def test_span_readers_on_the_tiny_traced_run(tmp_path):
    traced = run_tiny(make_root(tmp_path), trace=1)
    got = traced["metrics"]
    for name in DEVICE:
        assert name not in got, name
    for name in HOST:
        assert name in got, name
    assert 0 < got["driver_self_s"]["value"] < 1.0
    assert got["driver_self_s"]["unit"] == "s"
    # plane_scalars' 5 copies, add_at's 3, the six-map streams' 2, SYNC
    assert got["host_syncs_per_plane"]["value"] == 11
    assert got["host_syncs_per_plane"]["unit"] == "count"


class _Run:
    def __init__(self, log, trace, planes):
        self.span_log, self.trace, self.trace_planes = log, trace, planes


def _rec(name, parent, t0_us, t1_us, base, dev=None, counts=None):
    ns = int(base * 1e9)
    return SpanRecord(name, parent, (ns + int(t0_us * 1e3),
                                     ns + int(t1_us * 1e3)), dev, counts)


def test_idle_split_and_extents_on_a_made_up_trace():
    """One plane in a 100 us window: the device idle from 20 to 30 us (the
    host in DEPOSIT) goes to the phases, 50-60 (the host in SYNC) and
    90-100 (after the plane) to the driver."""
    base = spans.trace_base_s(1_792_000_000 * 10**9)
    t = 3600.0                       # the window's start on the trace clock
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench_window",
           "ts": t * 1e6, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": t * 1e6, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": t * 1e6 + 30,
           "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "c", "ts": t * 1e6 + 60,
           "dur": 30}]
    us = t * 1e6
    log = [_rec("PLANE", -1, us + 1, us + 70, base + 0, (0.0, 90e-6),
                {"host_sync": 4}),
           _rec("DEPOSIT", 0, us + 2, us + 25, base, (0.0, 20e-6)),
           _rec("SHT", 0, us + 25, us + 45, base, (30e-6, 50e-6)),
           _rec("SYNC", 0, us + 45, us + 70, base, (60e-6, 90e-6))]
    run = _Run(log, Trace(ev), 1)
    ph, dr = spans.idle_split(run)
    assert ph == pytest.approx(10e-6, abs=1e-9)
    assert dr == pytest.approx(20e-6, abs=1e-9)
    assert ph + dr == pytest.approx(run.trace.window_s - run.trace.busy_s)
    assert spans.device_s(run, ("DEPOSIT",)) == pytest.approx(20e-6)
    assert spans.driver_self_s(run) == pytest.approx(1e-6, abs=2e-9)
    assert spans.counter(run, "host_sync") == 4
    assert spans.counter(run, "device_alloc") is None
    # planes that do not lie in the window on the exporter's clock
    run.span_log = [r._replace(host=(r.host[0] + 10**9, r.host[1] + 10**9))
                    for r in log]
    assert spans.idle_split(run) is None
