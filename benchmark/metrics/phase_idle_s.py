"""phase_idle_s: the traced window's device idle time (the gaps of
device_idle_pct) whose start falls while the host is inside one of the
program's phase spans, per traced plane (benchmark/spans.py); none off the
card."""

from benchmark import spans


def read(run):
    split = spans.idle_split(run)
    return None if split is None else split[0]
