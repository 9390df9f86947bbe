"""Reads a torch.profiler chrome trace of the traced planes: the device's
busy time, the kernels' times by name, the largest device operations and
the longest idle gaps with what the host was doing in each.

The window is the span of the "bench_window" annotation the harness puts
around the traced planes.  The device is busy while a kernel, a copy or a
memset runs on it (the union of their intervals).
"""

from __future__ import annotations

import gzip
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench_window"


def short_name(name, width=160):
    """A kernel's name without its return type, anonymous namespace and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def _union(intervals):
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


class Trace:
    """A parsed trace: window_s, busy_s, device events [(name, t0, t1)] and
    host ops [(name, t0, t1)], all in seconds of the trace's clock."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
        if not win:
            raise ValueError("the trace holds no bench_window annotation")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        self.device = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b < w0 or a > w1:
                continue
            a, b = max(a, w0), min(b, w1)
            if e.get("cat") in DEVICE_CATS:
                self.device.append((e["name"], a * 1e-6, b * 1e-6))
            elif e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver"):
                self.host.append((e["name"], a * 1e-6, b * 1e-6))
        self.w0, self.w1 = w0 * 1e-6, w1 * 1e-6
        self.busy_s = _union([(a, b) for _, a, b in self.device])

    @classmethod
    def load(cls, path, keep=None):
        """The trace of the chrome-trace file path; with keep, the window
        and its device events are written there (gzip JSON) and path is
        removed (a traced plane at rayOrder 12 leaves ~100 MB of host
        events)."""
        with open(path) as fp:
            data = json.load(fp)
        events = data["traceEvents"] if isinstance(data, dict) else data
        if keep is not None:
            small = [e for e in events if e.get("cat") in DEVICE_CATS
                     or e.get("name") == WINDOW]
            with gzip.open(keep, "wt") as fp:
                json.dump({"traceEvents": small}, fp)
            os.remove(path)
        return cls(events)

    def kernel_seconds(self, names):
        """(seconds, launches) of the device kernels whose name holds one
        of names."""
        s, n = 0.0, 0
        for name, a, b in self.device:
            if any(k in name for k in names):
                s += b - a
                n += 1
        return s, n

    def device_ops(self, top=10):
        tot = defaultdict(float)
        for name, a, b in self.device:
            tot[short_name(name)] += b - a
        return sorted(([k, v] for k, v in tot.items()),
                       key=lambda t: -t[1])[:top]

    def idle_gaps(self, top=10):
        """The longest intervals of the window with no device operation,
        each named by the innermost host op running at its start."""
        gaps, end = [], self.w0
        for _, a, b in sorted(self.device, key=lambda t: t[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.w1 > end:
            gaps.append((end, self.w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            inner = [h for h in self.host if h[1] <= a < h[2]]
            name = (max(inner, key=lambda h: h[1])[0] if inner
                    else "host between ops")
            out.append([name, b - a])
        return out
