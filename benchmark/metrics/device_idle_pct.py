"""device_idle_pct: the share of the profiled planes' window in which no
kernel, copy or memset ran on the device (torch.profiler, no Profile)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
