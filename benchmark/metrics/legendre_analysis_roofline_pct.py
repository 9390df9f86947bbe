"""legendre_analysis_roofline_pct: the analysis's Legendre sums (K1 or K4)
against the least time their work needs on the card (roofline.py), over
the profiled planes: one analysis per plane, eight with SPH."""

from benchmark import roofline


def read(run):
    per_plane = 8 if run.cfg.DepositScheme == "SPH" else 1
    return roofline.trace_share(run, "legendre_analysis", "analysis",
                                per_plane)
