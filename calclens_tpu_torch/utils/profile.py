"""Per-phase timers of the Profile mode (reference profile.c's totals), and
the spans and counters of the plane step.

The part of calclens_tpu/utils/profile.py that the port's driver uses: the
totals and counts per tag and the per-task `timing` file, filled from
intervals the caller measures.  The analog of per-phase MPI wall times is
host wall-clock around device synchronisation points: torch.cuda.synchronize
on the device of a CUDA tensor, nothing for a CPU tensor (its work is done
when the call returns).

The spans: while a torch.profiler records, each plane step logs its PLANE
span (plane_span), the phases inside it (phase, the steps' default phase
hook: DEPOSIT, SHTSOLVE, SHT, RAYPROP, the multigrid and THREEDPOT
phases), the ring stages inside those (RINGS) and its closing SYNC, named
by the Profile tags.  Each span opens torch.profiler.record_function, so
it sits on the profiler's timeline beside its kernels, and records its
parent, its host enter and exit times and, on a CUDA device, a timing
event pair on the current stream at its edges: its device extent, with no
sync.  The host times are time.time_ns (the profiler's clock, Unix time
in ns) at the middle of record_function's enter and at the end of its
exit, nearest the profiler's own stamps; a chrome trace's ts is that time
less the exporter's base, in us.

count(name, n) adds to the open plane's counters, which its PLANE span
keeps: `host_sync` at each point of the step where the host waits for the
card (counted on the CPU too, where nothing waits: a CPU run counts what
the same step waits for on the card), `device_alloc` the caching
allocator's cudaMallocs within the plane.  Off the profiler span() returns
one shared no-op context and count() returns at once; the step checks for
a profiler once, at its start.  take() hands the log to a reader after the
window and empties it.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch

# spans kept in the log; a plane that starts with the log this full is
# not logged
LOG_MAX = 1 << 16
# the shared no-op context of span() with tracing off
NOOP = contextlib.nullcontext()

_on = False     # tracing on: inside a plane_span() that found a profiler
_stream = None  # the plane's CUDA stream (None off the card)
_log = []       # [name, parent, t0, t1, ev0, ev1, counts] per span
_stack = []     # indices in _log of the open spans
_counts = {}    # the open plane's counters


def sync(t):
    """Wait for the device work behind tensor t (or the tensors of a tuple
    or list): torch.cuda.synchronize on its device when it lives on a GPU,
    nothing on the CPU or for other values.  Each tensor counts one
    host_sync."""
    if isinstance(t, (tuple, list)):
        for x in t:
            sync(x)
    elif isinstance(t, torch.Tensor):
        count("host_sync")
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


class Profiler:
    def __init__(self):
        self.total = {}
        self.count = {}

    def add(self, tag, dt):
        """Accumulate one measured interval of dt seconds under tag."""
        self.total[tag] = self.total.get(tag, 0.0) + dt
        self.count[tag] = self.count.get(tag, 0) + 1

    def report(self):
        width = max((len(t) for t in self.total), default=8)
        lines = [f"{t:<{width}} {self.total[t]:12.6f}s  x{self.count[t]}"
                 for t in sorted(self.total, key=self.total.get, reverse=True)]
        return "\n".join(lines)

    def write(self, path):
        """Per-task `timing` file (reference printProfileInfo)."""
        with open(path, "w") as fp:
            fp.write(self.report() + "\n")


# ----------------------------------------------------------------------------
# spans and counters
# ----------------------------------------------------------------------------

class SpanRecord(NamedTuple):
    """One span of take()'s log."""

    name: str
    parent: int     # index in the log of the enclosing span, -1 for PLANE
    host: tuple     # (enter, exit): time.time_ns, the profiler's clock
    device: tuple   # (start, end) s after the log's first event; None off
    #                 the card
    counts: dict    # PLANE: its counters; None for the others


class _Span:
    """A span while tracing is on."""

    __slots__ = ("name", "rf", "i")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        a = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        t0 = (a + time.time_ns()) // 2
        ev = None
        if _stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(_stream)
        self.i = len(_log)
        _log.append([self.name, _stack[-1] if _stack else -1, t0, None, ev,
                     None, None])
        _stack.append(self.i)
        return self

    def __exit__(self, *exc):
        rec = _log[self.i]
        if _stream is not None:
            rec[5] = torch.cuda.Event(enable_timing=True)
            rec[5].record(_stream)
        _stack.pop()
        self.rf.__exit__(*exc)
        rec[3] = time.time_ns()
        return False


class _Plane(_Span):
    """The PLANE span: turns tracing on for the step, keeps its counters
    and the cudaMallocs within it."""

    __slots__ = ("dev", "alloc0")

    def __init__(self, device):
        super().__init__("PLANE")
        self.dev = device if device.type == "cuda" else None

    def __enter__(self):
        global _on, _stream, _counts
        _on, _counts = True, {}
        _stream = (None if self.dev is None
                   else torch.cuda.current_stream(self.dev))
        self.alloc0 = _device_allocs(self.dev)
        return super().__enter__()

    def __exit__(self, *exc):
        global _on, _stream
        if self.alloc0 is not None:
            count("device_alloc", _device_allocs(self.dev) - self.alloc0)
        _log[self.i][6] = _counts
        try:
            return super().__exit__(*exc)
        finally:
            _on, _stream = False, None
            _stack.clear()


def _device_allocs(dev):
    """The caching allocator's cudaMalloc count on dev (None off the
    card)."""
    if dev is None:
        return None
    return torch.cuda.memory_stats(dev).get("num_device_alloc")


def plane_span(device):
    """The PLANE span of one plane step on device: tracing is on inside it
    when a torch.profiler records as it starts (and the log has room), off
    otherwise (the shared no-op)."""
    if not torch.autograd._profiler_enabled() or len(_log) >= LOG_MAX:
        return NOOP
    return _Plane(torch.device(device))


def span(name):
    """A span named name inside the plane step (the shared no-op with
    tracing off)."""
    return _Span(name) if _on else NOOP


def spanned(name):
    """Decorator: each call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def count(name, n=1):
    """Add n to the open plane's counter name (nothing with tracing
    off)."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def phase(tag, fn, *args):
    """The plane steps' default phase hook: fn(*args) inside span(tag)."""
    with span(tag):
        return fn(*args)


def take():
    """The log of the spans recorded since the last take(), in the order
    they opened, as SpanRecords, and the log emptied.  Waits for the
    spans' CUDA events; device times are seconds after the first span's
    start event."""
    global _log
    log, _log = _log, []
    ends = [r[5] for r in log if r[5] is not None]
    if ends:
        ends[-1].synchronize()
    origin = next((r[4] for r in log if r[4] is not None), None)
    out = []
    for name, parent, t0, t1, ev0, ev1, counts in log:
        dev = None
        if ev0 is not None and ev1 is not None:
            dev = (origin.elapsed_time(ev0) * 1e-3,
                   origin.elapsed_time(ev1) * 1e-3)
        out.append(SpanRecord(name, parent, (t0, t1), dev, counts))
    return out
