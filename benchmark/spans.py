"""The program's span log of the traced planes, for the per-layer metrics
that read it (calclens_tpu_torch/utils/profile.py: PLANE, its phases, the
RINGS stages inside them and SYNC, with their host times, their device
extents from CUDA events and the PLANE's counters).

The log is taken once per run, after the window, and kept on the run.  A
program without the log (one from before it) gives None, and so does a
log that does not hold the traced planes; every reader then gives None.
Values are means per traced plane.
"""

from __future__ import annotations

# the chrome-trace exporter's base (libkineto's ChromeTraceBaseTime): Unix
# time floored to intervals of this many seconds; a trace's ts is the
# profiler's clock less it, in us
KINETO_BASE_S = 7889238
# how far (s) a plane's host span may lie outside the traced window
WINDOW_SLACK_S = 1e-3


def log(run):
    """The traced planes' SpanRecords (profile.take()), or None."""
    if "span_log" not in vars(run):
        from calclens_tpu_torch.utils import profile

        take = getattr(profile, "take", None)
        spans = take() if take is not None else None
        n = sum(s.name == "PLANE" for s in spans or ())
        run.span_log = spans if n and n == run.trace_planes else None
    return run.span_log


def planes(spans):
    return [i for i, s in enumerate(spans) if s.name == "PLANE"]


def phases(spans):
    """The phase spans: the PLANE's children other than SYNC."""
    return [s for s in spans if s.parent >= 0 and s.name != "SYNC"
            and spans[s.parent].name == "PLANE"]


def device_s(run, names):
    """The device extents of the spans named in names, summed, per plane
    (None off the card)."""
    spans = log(run)
    if spans is None or spans[0].device is None:
        return None
    tot = sum(s.device[1] - s.device[0] for s in spans if s.name in names)
    return tot / len(planes(spans))


def driver_self_s(run):
    """Host time in PLANE not covered by its children (its phases and
    SYNC), per plane."""
    spans = log(run)
    if spans is None:
        return None
    tot = sum(s.host[1] - s.host[0] for s in spans if s.name == "PLANE")
    tot -= sum(s.host[1] - s.host[0] for s in spans
               if s.parent >= 0 and spans[s.parent].name == "PLANE")
    return tot * 1e-9 / len(planes(spans))


def counter(run, name):
    """The PLANE spans' counter name, per plane (None where no plane
    counted it)."""
    spans = log(run)
    if spans is None:
        return None
    got = [spans[i].counts.get(name) for i in planes(spans)]
    if all(v is None for v in got):
        return None
    return sum(v or 0 for v in got) / len(got)


def trace_base_s(t_ns):
    """The exporter's base, in s, for a profile taken at t_ns."""
    return (t_ns // 10**9 // KINETO_BASE_S) * KINETO_BASE_S


def idle_split(run):
    """(phase_idle_s, driver_idle_s): the traced window's device idle gaps
    (as tracing.Trace.idle_gaps finds them), each put down to a phase when
    the host is inside a phase span at the gap's start, else to the driver
    (in PLANE outside its phases, in SYNC, between planes); per plane.
    None off the card, or where the PLANE spans do not lie in the window
    on the exporter's clock."""
    spans, tr = log(run), run.trace
    if spans is None or tr is None or not tr.device:
        return None
    base = trace_base_s(spans[0].host[0])

    def host_s(s):
        return (s.host[0] * 1e-9 - base, s.host[1] * 1e-9 - base)

    for i in planes(spans):
        a, b = host_s(spans[i])
        if a < tr.w0 - WINDOW_SLACK_S or b > tr.w1 + WINDOW_SLACK_S:
            return None
    inside = sorted(host_s(s) for s in phases(spans))
    ph = dr = 0.0
    end = tr.w0
    for _, a, b in sorted(tr.device, key=lambda t: t[1]):
        if a > end:
            if any(h0 <= end < h1 for h0, h1 in inside):
                ph += a - end
            else:
                dr += a - end
        end = max(end, b)
    if tr.w1 > end:
        dr += tr.w1 - end
    n = len(planes(spans))
    return ph / n, dr / n
