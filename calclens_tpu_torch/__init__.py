"""PyTorch / CUDA port of calclens_tpu: the full-sky, SHT-only, NGP plane
step and its multiple-plane driver on one device.

Plain tensor work is PyTorch; the Legendre sweeps of the spherical-harmonic
transform are hand-written CUDA kernels for Hopper (csrc/, built at first
use by _ext.py).  The host modules the port needs (config, cosmology,
healpix.core, io) are its own copies of the JAX package's.  This package
imports neither jax nor calclens_tpu.
"""
