"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Marked `cuda`; each test skips (inside the `cuda_device` fixture)
when torch sees no GPU.  Run on a machine with the card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

(--noconftest: tests/conftest.py sets up jax, which the card's machine does
not have.)  Inputs are random alm with a red spectrum and random ring sums
made with numpy at HEALPix orders 4-9.  Tolerance: max |kernel - twin| /
max |twin| < 1e-5 per output column.  Kernel and twin round the lambda
recurrence alike; they differ only in the order (and FMA contraction) of
the float32 sums over up to 3 nside terms, measured at <= 4e-7 on an H100
through order 12."""
import numpy as np
import pytest
import torch

from calclens_tpu_torch import _ext
from calclens_tpu_torch.sht import legendre as TL
from calclens_tpu_torch.sht import transforms as T
from calclens_tpu_torch.sht.plan import SHTPlan

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _relerr(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _alm(plan, seed):
    rng = np.random.default_rng(seed)
    l = np.arange(plan.nl)[:, None]
    m = np.arange(plan.nm)[None, :]
    alm = np.where(m <= l, rng.normal(size=(plan.nl, plan.nm))
                   + 1j * rng.normal(size=(plan.nl, plan.nm)), 0.0)
    # a red spectrum like the potential's, so high l do not dominate
    alm = alm / (1.0 + l) ** 1.5
    return torch.tensor(alm.astype(np.complex64), device=plan.device)


@pytest.mark.parametrize("order", [4, 6, 8])
def test_synth_kernel_matches_twin(cuda_device, order):
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    streams = TL.mx_prep(plan.nl, plan.nm, _alm(plan, order), torch.float32)
    before = _ext.launches["legendre_synth"]
    got = TL.synth_cuda(*streams, plan.cth, plan.ln_sth, plan.logc)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_synth"] == before + 1
    ref = TL.synth_plain(*streams, plan.cth, plan.ln_sth, plan.logc)
    assert got.shape == ref.shape == (plan.nm, 16, plan.J)
    for c in range(16):
        assert _relerr(got[:, c], ref[:, c]) < TOL, c


@pytest.mark.parametrize("order", [4, 6, 8])
def test_analysis_kernel_matches_twin(cuda_device, order):
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(100 + order)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, plan.J))
                          + 1j * rng.normal(size=(plan.nm, plan.J))
                          ).astype(np.complex64), device=cuda_device)
            for _ in range(2))
    args = TL.analysis_inputs(plan, E, O)
    before = _ext.launches["legendre_analysis"]
    re, im = TL.analysis_cuda(*args, plan.nl)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_analysis"] == before + 1
    rre, rim = TL.analysis_plain(*args, plan.nl)
    assert _relerr(re, rre) < TOL and _relerr(im, rim) < TOL


def test_analysis_kernel_honours_tile_cutoff(cuda_device):
    """A forced per-tile cutoff: the kernel and the twin skip the same
    (m, tile) pairs (order 9: J = 1024 rings, two 512-ring tiles)."""
    plan = SHTPlan(9, cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(9)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, plan.J))
                          + 1j * rng.normal(size=(plan.nm, plan.J))
                          ).astype(np.complex64), device=cuda_device)
            for _ in range(2))
    *planes, cth, ln_sth, logc, _ = TL.analysis_inputs(plan, E, O)
    mcut = torch.tensor([40, 700], dtype=torch.int32, device=cuda_device)
    re, im = TL.analysis_cuda(*planes, cth, ln_sth, logc, mcut, plan.nl)
    rre, rim = TL.analysis_plain(*planes, cth, ln_sth, logc, mcut, plan.nl)
    assert _relerr(re, rre) < TOL and _relerr(im, rim) < TOL


def test_kernels_refuse_float64_cuda_tensors(cuda_device):
    plan = SHTPlan(3, cuda_device, dtype=torch.float64)
    x = torch.zeros((plan.nm, plan.J), dtype=torch.float64,
                    device=cuda_device)
    mcut = torch.tensor(TL.analysis_mcut(plan.sth_host, plan.nl, plan.nm),
                        device=cuda_device)
    with pytest.raises(TypeError, match="float32 only"):
        TL.analysis_columns(x, x, x, x, plan.cth, plan.ln_sth, plan.logc,
                            mcut, plan.nl)
    s = torch.zeros((plan.nm, plan.nl), dtype=torch.float64,
                    device=cuda_device)
    with pytest.raises(TypeError, match="float32 only"):
        TL.synth_columns(s, s, s, s, plan.cth, plan.ln_sth, plan.logc)
    alm = torch.zeros((plan.nl, plan.nm), dtype=torch.complex128,
                      device=cuda_device)
    with pytest.raises(TypeError, match="float32 only"):
        T.legendre_synthesis(plan, alm)
