"""Test harnesses: analytic point-mass and NFW planes, the exact SPH
deposit oracle (the port's copies of calclens_tpu/testing)."""
