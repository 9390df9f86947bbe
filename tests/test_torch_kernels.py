"""The hand-written CUDA kernels (K1, K2 with 16 and 4 columns, K3 in both
forms, K4, the probes P1-P4) against their plain PyTorch twins, and the
lens-map accumulation on the card against the CPU, on the card.  Marked
`cuda`; each test skips (inside the `cuda_device` fixture) when torch sees
no GPU.  Run on a machine with the card:

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
from calclens_tpu_torch import maps as tmaps
from calclens_tpu_torch.sht import legendre as TL
from calclens_tpu_torch.sht import transforms as T
from calclens_tpu_torch.sht.plan import SHTPlan
from calclens_tpu_torch.tools import exp_gather as G
from calclens_tpu_torch.tools import roofline_legendre as R

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
    got = TL.synth_cuda(streams, plan.cth, plan.ln_sth, plan.logc)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_synth"] == before + 1
    ref = TL.synth_plain(streams, plan.cth, plan.ln_sth, plan.logc)
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


@pytest.mark.parametrize("order", [4, 6, 8])
def test_synth_phi_kernel_matches_twin(cuda_device, order):
    """K2's potential-only form: 4 columns, its own launch counter."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    streams = TL.mx_prep(plan.nl, plan.nm, _alm(plan, 300 + order),
                         torch.float32, derivs=False)
    before = _ext.launches["legendre_synth_phi"]
    got = TL.synth_cuda(streams, plan.cth, plan.ln_sth, plan.logc)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_synth_phi"] == before + 1
    ref = TL.synth_plain(streams, plan.cth, plan.ln_sth, plan.logc)
    assert got.shape == ref.shape == (plan.nm, 4, plan.J)
    for c in range(4):
        assert _relerr(got[:, c], ref[:, c]) < TOL, c


@pytest.mark.parametrize("order", [4, 6, 8])
@pytest.mark.parametrize("derivs", [True, False])
def test_synth_vpu_kernel_matches_twin(cuda_device, order, derivs):
    """K3: every bucket column against the twin (same chain seed)."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    a_re, a_im = TL.mx_prep(plan.nl, plan.nm, _alm(plan, 400 + order),
                            torch.float32, derivs=False)
    geo = (plan.cth, plan.sth, plan.cot, plan.inv_sth)
    before = _ext.launches["legendre_synth_vpu"]
    got = TL.synth_vpu_cuda(a_re, a_im, *geo, derivs)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_synth_vpu"] == before + 1
    ref = TL.synth_vpu_plain(a_re, a_im, *geo, derivs)
    ncol = 12 if derivs else 4
    assert got.shape == ref.shape == (plan.nm, ncol, plan.J)
    for c in range(ncol):
        assert _relerr(got[:, c], ref[:, c]) < TOL, c


@pytest.mark.parametrize("order", [4, 6, 8])
def test_analysis_dot_kernel_matches_twin_and_k1(cuda_device, order):
    """K4 against its twin, and against K1 on the same inputs (the same
    lambda bits, summed in another order)."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(500 + order)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, plan.J))
                          + 1j * rng.normal(size=(plan.nm, plan.J))
                          ).astype(np.complex64), device=cuda_device)
            for _ in range(2))
    args = TL.analysis_inputs(plan, E, O)
    before = _ext.launches["legendre_analysis_dot"]
    re, im = TL.analysis_dot_cuda(*args, plan.nl)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_analysis_dot"] == before + 1
    rre, rim = TL.analysis_dot_plain(*args, plan.nl)
    assert _relerr(re, rre) < TOL and _relerr(im, rim) < TOL
    kre, kim = TL.analysis_cuda(*args, plan.nl)
    assert _relerr(re, kre) < TOL and _relerr(im, kim) < TOL


def test_analysis_kernel_honours_tile_cutoff(cuda_device):
    """A forced per-tile cutoff: K1, K4 and the twin skip the same
    (m, tile) pairs (order 9: J = 1024 rings, two 512-ring tiles)."""
    plan = SHTPlan(9, cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(9)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, plan.J))
                          + 1j * rng.normal(size=(plan.nm, plan.J))
                          ).astype(np.complex64), device=cuda_device)
            for _ in range(2))
    *planes, cth, ln_sth, logc, _ = TL.analysis_inputs(plan, E, O)
    mcut = torch.tensor([40, 700], dtype=torch.int32, device=cuda_device)
    rre, rim = TL.analysis_plain(*planes, cth, ln_sth, logc, mcut, plan.nl)
    for launch in (TL.analysis_cuda, TL.analysis_dot_cuda):
        re, im = launch(*planes, cth, ln_sth, logc, mcut, plan.nl)
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
    for streams in ((s, s, s, s), (s, s)):
        with pytest.raises(TypeError, match="float32 only"):
            TL.synth_columns(streams, plan.cth, plan.ln_sth, plan.logc)
    with pytest.raises(TypeError, match="float32 only"):
        TL.synth_vpu_columns(s, s, plan.cth, plan.sth, plan.cot,
                             plan.inv_sth, True)
    with pytest.raises(TypeError, match="float32 only"):
        TL.analysis_dot_columns(x, x, x, x, plan.cth, plan.ln_sth,
                                plan.logc, mcut, plan.nl)
    alm = torch.zeros((plan.nl, plan.nm), dtype=torch.complex128,
                      device=cuda_device)
    with pytest.raises(TypeError, match="float32 only"):
        T.legendre_synthesis(plan, alm)


# shapes at which the probe's recurrence stays finite: one m row per
# 512-thread block with 8-degree refills (m < 128, 16 degrees); and the
# layout that ceilings() times, two m rows per 256-ring block with
# 128-degree refills, on two blocks of rows and two refills (m < 4, 256
# degrees)
PROBE_SHAPES = {"one-row": dict(MT=4, LBLK=2, LB=8, TM=32, TJ=512),
                "timed-layout": dict(MT=2, LBLK=2, LB=128, TM=2, TJ=256)}


@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("mode", ["rec", "rec+store", "store", "dot"])
def test_roofline_probe_matches_plain(cuda_device, mode, shape):
    """P1 against its plain version: the kernel and the plain version round
    every operation alike, bound 1e-6 of max |plain|; dot sums its FMAs in
    another order, 1e-5."""
    shape = PROBE_SHAPES[shape]
    geo = R.default_geo(shape["TJ"], cuda_device)
    before = _ext.launches["roofline_probe"]
    got = R.probe(geo=geo, mode=mode, **shape)
    torch.cuda.synchronize()
    assert _ext.launches["roofline_probe"] == before + 1
    ref = R.probe_plain(geo=geo, mode=mode, **shape)
    assert got.shape == ref.shape and bool(torch.isfinite(ref).all())
    assert _relerr(got, ref) <= (1e-5 if mode == "dot" else 1e-6)


@pytest.mark.parametrize("mode", ["store", "dot"])
def test_roofline_probe_matches_plain_at_default_shape(cuda_device, mode):
    """The two modes whose values stay finite at the tool's default shape
    (6.44e9 elements), against the plain version there: store exactly; dot
    sums 8192 FMAs per output in another order, 1e-5."""
    sh = R.DEFAULT_SHAPE
    geo = R.default_geo(sh["TJ"], cuda_device)
    got = R.probe(geo=geo, mode=mode, **sh)
    ref = R.probe_plain(geo=geo, mode=mode, **sh)
    assert got.shape == ref.shape
    assert _relerr(got, ref) <= (1e-5 if mode == "dot" else 0.0)


@pytest.mark.parametrize("name", ["gather_rows", "gather_lanes",
                                  "gather_onehot"])
def test_gather_kernels_bit_exact(cuda_device, name):
    """P2-P4 equal torch's tab[idx] bit for bit, on a ragged count of
    indices; an index outside the table gives a row of NaN."""
    tab, idx = G.inputs(n=(1 << 16) + 17, seed=7, device=cuda_device)
    idx[5] = -1
    idx[9] = G.W
    ok = torch.ones(len(idx), dtype=torch.bool, device=cuda_device)
    ok[5] = ok[9] = False
    before = _ext.launches[name]
    if name == "gather_lanes":
        got = G.gather_lanes(tab.T.contiguous(), idx).T
    else:
        got = getattr(G, name)(tab, idx)
    torch.cuda.synchronize()
    assert _ext.launches[name] == before + 1
    assert torch.equal(got[ok], tab[idx[ok]])
    assert bool(torch.isnan(got[~ok]).all())


def test_lens_map_accumulation_on_the_card(cuda_device):
    """The full-sky lens-map sums of a random f32 ray buffer on the card
    against the same function on the CPU: counts exact, the rest within
    1e-5 of each row's max (float32 sums of 4^4 children in another
    order)."""
    rng = np.random.default_rng(12)
    order, map_order = 8, 4
    npix = 12 * 4**order
    packed = rng.normal(size=(21, npix)).astype(np.float32)
    got = tmaps.accum_lens_map_packed(
        torch.tensor(packed, device=cuda_device), None, order, map_order)
    ref = tmaps.accum_lens_map_packed(torch.tensor(packed), None, order,
                                      map_order)
    got = got.cpu()
    assert torch.equal(got[0], ref[0])
    for k in range(1, 7):
        assert _relerr(got[k], ref[k]) < 1e-5, k
