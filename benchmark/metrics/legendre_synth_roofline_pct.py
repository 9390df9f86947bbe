"""legendre_synth_roofline_pct: the synthesis's Legendre sums (K2, or K3
and its seed pre-pass) against the least time their work needs on the card
(roofline.py), over the profiled planes: one synthesis per plane, the
six-map one in the SHT-only step, the potential alone in the multigrid
step."""

from benchmark import roofline


def read(run):
    function = "synthesis" if run.cfg.SHTOnly else "synthesis_phi"
    return roofline.trace_share(run, "legendre_synth", function, 1)
