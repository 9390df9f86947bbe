"""PyTorch / CUDA port of calclens_tpu: the full-sky, SHT-only, NGP plane
step and its multiple-plane driver on one device.

Plain tensor work is PyTorch; the two Legendre sweeps of the spherical-
harmonic transform are hand-written CUDA kernels for Hopper (csrc/, built at
first use by _ext.py).  Host-only, JAX-free modules of calclens_tpu (config,
cosmology, healpix.core, io) are reused as they are.  This package never
imports jax.
"""
