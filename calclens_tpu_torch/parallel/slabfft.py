"""Slab-decomposed distributed 3D real FFT (reference DD-4: fftw3-mpi slab
decomposition, fftpoissonsolve.c:486-519), on a mesh of ranks.

Port of calclens_tpu/parallel/slabfft.py.  Each rank holds an x-slab
[nfft / n, nfft, nfft] of the grid.  Forward: a local rfft on z and fft on
y, one all-to-all (Mesh.exchange) that turns the x-slabs into y-slabs,
then the fft on x.  The kernel multiplies the spectrum in that y-sharded
layout, and the inverse retraces the steps.  The JAX package runs these
stages in one shard_map region; here they are torch.fft calls (cuFFT on
the card) between two explicit exchanges.
"""

from __future__ import annotations

import numpy as np
import torch


def _transpose(X, mesh, split: int, concat: int):
    """The slab transpose: X's axis `split` cut into n equal chunks, chunk
    d sent to rank d; the pieces received, one per source rank, joined
    along axis `concat` in rank order."""
    n = mesh.size
    send = list(torch.chunk(X, n, dim=split))
    shape = list(X.shape)
    shape[split] //= n
    pieces = mesh.exchange(send, [int(np.prod(shape))] * n, X.dtype)
    return torch.cat([p.view(shape) for p in pieces], dim=concat)


def poisson_slab(slab, nfft: int, kern_fn, mesh):
    """slab [nfft / n, nfft, nfft] real (this rank's x rows) -> the
    kern-filtered real grid, the same x rows.  kern_fn(kx [nfft, 1, 1],
    ky [1, nfft / n, 1], kz [1, 1, nfft / 2 + 1]) gives the kernel at the
    integer frequencies, evaluated in the y-sharded spectral layout (ky:
    this rank's block of fftfreq); it is cast to the spectrum's dtype
    (complex64 for a float32 slab), as the JAX package casts it."""
    p, r = mesh.size, mesh.rank
    assert nfft % p == 0, (nfft, p)
    nly = nfft // p
    kfull = torch.as_tensor(np.fft.fftfreq(nfft).astype(np.float32) * nfft,
                            device=slab.device)
    khalf = torch.as_tensor(np.fft.rfftfreq(nfft).astype(np.float32) * nfft,
                            device=slab.device)

    X = torch.fft.fft(torch.fft.rfft(slab, dim=2), dim=1)   # [nlx, N, K]
    # y chunk d -> rank d; sender s's piece holds x rows s * nlx ...: the
    # pieces joined in sender order give x in global order
    X = torch.fft.fft(_transpose(X, mesh, 1, 0), dim=0)     # [N, nly, K]
    kern = kern_fn(kfull[:, None, None],
                   kfull[r * nly:(r + 1) * nly][None, :, None],
                   khalf[None, None, :])
    X = torch.fft.ifft(X.mul_(kern.to(X.dtype)), dim=0)
    del kern
    # x chunk d -> rank d; sender s's piece is its y chunk s of this
    # rank's x rows: joined in sender order, y in global order (the JAX
    # comment at calclens_tpu/parallel/slabfft.py:41-47)
    X = torch.fft.ifft(_transpose(X, mesh, 0, 1), dim=1)    # [nlx, N, K]
    return torch.fft.irfft(X, n=nfft, dim=2)
