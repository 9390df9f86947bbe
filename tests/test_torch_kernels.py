"""The hand-written CUDA kernels (K1, K2 with 16 and 4 columns, K3 in both
forms with its seed pre-pass, K4, the probes P1-P4) against their plain PyTorch twins, and the
lens-map accumulation on the card against the CPU, on the card.  Marked
`cuda`; each test skips (inside the `cuda_device` fixture) when torch sees
no GPU.  Run on a machine with the card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

(--noconftest: tests/conftest.py sets up jax, which the card's machine does
not have.)  Inputs are random alm with a red spectrum and random ring sums
made with numpy at HEALPix orders 4-10.  Tolerance: max |kernel - twin| /
max |twin| < 1e-5 per output column.  Kernel and twin round the lambda
recurrence alike; they differ only in the order (and FMA contraction) of
the float32 sums over up to 3 nside terms, measured at <= 4e-7 on an H100
through order 12; K4 contracts high and low TF32 parts of lambda and of
its sources on the tensor cores, ~1e-6 from its twin and from K1."""
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


@pytest.mark.parametrize("order", [4, 6, 8, 10])
def test_synth_kernel_matches_twin(cuda_device, order):
    """K2 with the plan's cutoff (active from order 8 on) against the twin
    with the same cutoff."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    streams = TL.mx_prep(plan.nl, plan.nm, _alm(plan, order), torch.float32)
    geo = (plan.cth, plan.ln_sth, plan.logc, plan.mcut(TL.SYNTH_TILE_J))
    before = _ext.launches["legendre_synth"]
    got = TL.synth_cuda(streams, *geo)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_synth"] == before + 1
    ref = TL.synth_plain(streams, *geo)
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


@pytest.mark.parametrize("order", [4, 6, 8, 10])
def test_synth_phi_kernel_matches_twin(cuda_device, order):
    """K2's potential-only form: 4 columns, its own launch counter; the
    plan's cutoff as for K2."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    streams = TL.mx_prep(plan.nl, plan.nm, _alm(plan, 300 + order),
                         torch.float32, derivs=False)
    geo = (plan.cth, plan.ln_sth, plan.logc, plan.mcut(TL.SYNTH_TILE_J))
    before = _ext.launches["legendre_synth_phi"]
    got = TL.synth_cuda(streams, *geo)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_synth_phi"] == before + 1
    ref = TL.synth_plain(streams, *geo)
    assert got.shape == ref.shape == (plan.nm, 4, plan.J)
    for c in range(4):
        assert _relerr(got[:, c], ref[:, c]) < TOL, c


@pytest.mark.parametrize("order", [4, 6, 8])
@pytest.mark.parametrize("derivs", [True, False])
def test_synth_vpu_kernel_matches_twin(cuda_device, order, derivs):
    """K3: every bucket column against the twin (same chain seed, the
    plan's cutoff, active from order 8 on); one launch of the form's kernel
    and one of the seed pre-pass."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    a_re, a_im = TL.mx_prep(plan.nl, plan.nm, _alm(plan, 400 + order),
                            torch.float32, derivs=False)
    geo = (plan.cth, plan.sth, plan.cot, plan.inv_sth)
    mcut = plan.mcut(TL.SYNTH_TILE_J)
    name = "legendre_synth_vpu" if derivs else "legendre_synth_vpu_phi"
    before = dict(_ext.launches)
    got = TL.synth_vpu_cuda(a_re, a_im, *geo, derivs, mcut)
    torch.cuda.synchronize()
    assert _ext.launches[name] == before[name] + 1
    assert (_ext.launches["legendre_chain_seed"]
            == before["legendre_chain_seed"] + 1)
    ref = TL.synth_vpu_plain(a_re, a_im, *geo, derivs, mcut=mcut)
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


def _synth_both_forms(plan, rings, mcut, seed):
    """K2 and K2-4col on the ring pairs `rings` (a slice) with cutoff
    `mcut` against their twins: each column within TOL; entries beyond the
    cutoff exactly 0; the single-degree row m = nl - 1 within TOL."""
    cth, ln_sth = (x[rings].contiguous() for x in (plan.cth, plan.ln_sth))
    J = cth.shape[0]
    m = torch.arange(plan.nm, device=cth.device)
    cut = m[:, None] >= mcut.long().repeat_interleave(TL.SYNTH_TILE_J)[:J]
    for derivs in (True, False):
        streams = TL.mx_prep(plan.nl, plan.nm, _alm(plan, seed), torch.float32,
                             derivs=derivs)
        got = TL.synth_cuda(streams, cth, ln_sth, plan.logc, mcut)
        ref = TL.synth_plain(streams, cth, ln_sth, plan.logc, mcut)
        assert got.shape == ref.shape == (plan.nm, 16 if derivs else 4, J)
        for c in range(got.shape[1]):
            assert _relerr(got[:, c], ref[:, c]) < TOL, (derivs, c)
        assert not bool(got.permute(1, 0, 2)[:, cut].any())
        assert _relerr(got[-1], ref[-1]) < TOL


def test_synth_kernel_ragged_rings_and_degrees(cuda_device):
    """A ring count that fills no block (300 of order 8's ring pairs: two
    full 128-ring tiles and a ragged one) and an odd band limit (nl = 301,
    so nl - m takes every residue of the 8-degree groups), with the rule's
    cutoff on those rings, which cuts the first tile."""
    plan = SHTPlan(8, cuda_device, lmax=300, dtype=torch.float32)
    rings = slice(0, 300)
    mcut = torch.as_tensor(TL.synth_mcut(plan.sth_host[rings], plan.nl,
                                         plan.nm), device=cuda_device)
    assert int(mcut[0]) < plan.nm
    _synth_both_forms(plan, rings, mcut, 600)


def test_synth_kernel_uncut_polar_caps(cuda_device):
    """No cutoff on the 512 most polar ring pairs of order 10: rows whose
    scale counter stays below 0 for hundreds of degrees (or for good), so
    the warps switch from the careful to the bare recurrence at different
    degrees, or never."""
    plan = SHTPlan(10, cuda_device, dtype=torch.float32)
    mcut = torch.full((512 // TL.SYNTH_TILE_J,), plan.nm, dtype=torch.int32,
                      device=cuda_device)
    _synth_both_forms(plan, slice(0, 512), mcut, 601)


@pytest.mark.parametrize("order", [8, 10, 11])
def test_chain_seed_prepass_is_bit_exact(cuda_device, order):
    """K3's seed pre-pass equals the twin's chain (chain_seed of every m)
    bit for bit, values and scale counters; one launch."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    before = _ext.launches["legendre_chain_seed"]
    seed, seed_k = TL.chain_seed_cuda(plan.sth, plan.nm)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_chain_seed"] == before + 1
    ref, ref_k = TL.chain_seed(torch.arange(plan.nm), plan.sth)
    assert torch.equal(seed, ref) and torch.equal(seed_k, ref_k)
    assert int(seed_k.min()) < 0  # the rescale is exercised


@pytest.mark.parametrize("J", [1, 33, 1000])
def test_chain_seed_prepass_cut_rings(cuda_device, J):
    """The pre-pass on the first J ring pairs of the order-10 grid (polar
    rings: the rescale runs), a J that fills no whole block or warp, with
    the grid's nm and with nm = 700, not a multiple of the checkpoint
    segment: bit for bit chain_seed."""
    plan = SHTPlan(10, cuda_device, dtype=torch.float32)
    sth = plan.sth[:J].contiguous()
    for nm in (plan.nm, 700):
        seed, seed_k = TL.chain_seed_cuda(sth, nm)
        ref, ref_k = TL.chain_seed(torch.arange(nm), sth)
        assert seed.shape == (nm, J)
        assert torch.equal(seed, ref) and torch.equal(seed_k, ref_k), nm


def test_chain_seed_prepass_extreme_rings_and_segment_edges(cuda_device):
    """Rings the producers' scaled walk takes (sin theta from 2^-40 to 1)
    and rings it leaves to the plain chain (0, just below 2^-40), shuffled
    so warps hold both; rescales fall on checkpoint edges; nm = 1000 is no
    multiple of the segment.  Bit for bit chain_seed."""
    rng = np.random.default_rng(9)
    s = np.exp2(rng.uniform(-45.0, 0.0, 700)).astype(np.float32)
    s[:4] = 1.0
    s[4:6] = 0.0
    s[6:8] = np.float32(2.0**-40)
    s[8:10] = np.nextafter(np.float32(2.0**-40), np.float32(0.0))
    sth = torch.tensor(rng.permutation(s), device=cuda_device)
    nm = 1000
    ref, ref_k = TL.chain_seed(torch.arange(nm), sth)
    seg = TL.SEED_SEGMENT
    scaled = (sth >= 2.0**-40) & (sth <= 1.0)
    for edge in range(seg, nm, seg):
        assert bool(((ref_k[edge] != ref_k[edge - 1]) & scaled).any()), edge
    seed, seed_k = TL.chain_seed_cuda(sth, nm)
    assert torch.equal(seed, ref) and torch.equal(seed_k, ref_k)


def test_synth_vpu_kernel_reads_a_given_seed_table(cuda_device):
    """K3 given its pre-pass's table launches no pre-pass of its own and
    gives the same buckets, bit for bit (no atomics: deterministic)."""
    plan = SHTPlan(8, cuda_device, dtype=torch.float32)
    mcut = plan.mcut(TL.SYNTH_TILE_J)
    a_re, a_im = TL.mx_prep(plan.nl, plan.nm, _alm(plan, 604), torch.float32,
                            derivs=False)
    geo = (plan.cth, plan.sth, plan.cot, plan.inv_sth)
    table = TL.chain_seed_cuda(plan.sth, plan.nm)
    for derivs in (True, False):
        own = TL.synth_vpu_cuda(a_re, a_im, *geo, derivs, mcut)
        before = _ext.launches["legendre_chain_seed"]
        given = TL.synth_vpu_cuda(a_re, a_im, *geo, derivs, mcut, table)
        torch.cuda.synchronize()
        assert _ext.launches["legendre_chain_seed"] == before
        assert torch.equal(own, given)
    with pytest.raises(TypeError, match="seed_k"):
        TL.synth_vpu_cuda(a_re, a_im, *geo, True, mcut,
                          (table[0], table[1].float()))


def _synth_vpu_both_forms(plan, rings, mcut, seed):
    """K3 with and without derivatives on the ring pairs `rings` (a slice)
    with cutoff `mcut` against its twin, as _synth_both_forms holds K2."""
    geo = tuple(x[rings].contiguous()
                for x in (plan.cth, plan.sth, plan.cot, plan.inv_sth))
    J = geo[0].shape[0]
    m = torch.arange(plan.nm, device=geo[0].device)
    cut = m[:, None] >= mcut.long().repeat_interleave(TL.SYNTH_TILE_J)[:J]
    a_re, a_im = TL.mx_prep(plan.nl, plan.nm, _alm(plan, seed), torch.float32,
                            derivs=False)
    for derivs in (True, False):
        got = TL.synth_vpu_cuda(a_re, a_im, *geo, derivs, mcut)
        ref = TL.synth_vpu_plain(a_re, a_im, *geo, derivs, mcut=mcut)
        assert got.shape == ref.shape == (plan.nm, 12 if derivs else 4, J)
        for c in range(got.shape[1]):
            assert _relerr(got[:, c], ref[:, c]) < TOL, (derivs, c)
        assert not bool(got.permute(1, 0, 2)[:, cut].any())
        assert _relerr(got[-1], ref[-1]) < TOL


def test_synth_vpu_kernel_ragged_rings_and_degrees(cuda_device):
    """K3 on the ragged rings and odd band limit of
    test_synth_kernel_ragged_rings_and_degrees (300 ring pairs of order 8,
    nl = 301), with the rule's cutoff on those rings."""
    plan = SHTPlan(8, cuda_device, lmax=300, dtype=torch.float32)
    rings = slice(0, 300)
    mcut = torch.as_tensor(TL.synth_mcut(plan.sth_host[rings], plan.nl,
                                         plan.nm), device=cuda_device)
    assert int(mcut[0]) < plan.nm
    _synth_vpu_both_forms(plan, rings, mcut, 602)


def test_synth_vpu_kernel_uncut_polar_caps(cuda_device):
    """K3 without a cutoff on the 512 most polar ring pairs of order 10,
    where the scale counters stay below 0 for hundreds of degrees (a ring
    can reach k == -1 inside a zero-mode group) and the warps switch modes
    at different degrees, or never."""
    plan = SHTPlan(10, cuda_device, dtype=torch.float32)
    mcut = torch.full((512 // TL.SYNTH_TILE_J,), plan.nm, dtype=torch.int32,
                      device=cuda_device)
    _synth_vpu_both_forms(plan, slice(0, 512), mcut, 603)


# m rows on which K4 is held to its twin at large orders (chip_smoke.py's)
CHECK_ROWS = (0, 1, 2, 3, 511, 2048, 6143, 10001, 12287)


@pytest.mark.parametrize("order", [8, 10, 12])
def test_analysis_dot_tensor_cores_match_twin_and_k1(cuda_device, order):
    """K4's tensor-core contraction (TF32 parts, float32 accuracy) on the
    CHECK_ROWS rows below nm: against the twin run on those rows alone and
    against K1, 1e-5 of max; one launch."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(700 + order)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, plan.J))
                          + 1j * rng.normal(size=(plan.nm, plan.J))
                          ).astype(np.complex64), device=cuda_device)
            for _ in range(2))
    args = TL.analysis_inputs(plan, E, O)
    before = _ext.launches["legendre_analysis_dot"]
    re, im = TL.analysis_dot_cuda(*args, plan.nl)
    torch.cuda.synchronize()
    assert _ext.launches["legendre_analysis_dot"] == before + 1
    m = torch.tensor([r for r in CHECK_ROWS if r < plan.nm],
                     device=cuda_device)
    rre, rim = TL.analysis_dot_plain(*(x[m] for x in args[:4]), plan.cth,
                                     plan.ln_sth, plan.logc[m], args[7],
                                     plan.nl, m=m)
    assert _relerr(re[m], rre) < TOL and _relerr(im[m], rim) < TOL
    kre, kim = TL.analysis_cuda(*args, plan.nl)
    assert _relerr(re, kre) < TOL and _relerr(im, kim) < TOL


@pytest.mark.parametrize("order", [9, 10])
def test_analysis_kernels_bit_reproducible_and_row_local(cuda_device, order):
    """K1 and K4 at orders whose rings fill more than one 512-ring tile
    (J = 1024, 2048), where the tiles of a degree are combined: two
    launches on the same inputs give the same bits (the tiles are added in
    a fixed order), and a launch on a block of m rows (m0 > 0, as a rank
    of a mesh launches them) gives the whole launch's rows bit for bit."""
    plan = SHTPlan(order, cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(900 + order)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, plan.J))
                          + 1j * rng.normal(size=(plan.nm, plan.J))
                          ).astype(np.complex64), device=cuda_device)
            for _ in range(2))
    args = TL.analysis_inputs(plan, E, O)
    m0, m1 = plan.nm // 3, plan.nm // 3 + plan.nm // 4
    rows = (*(x[m0:m1].contiguous() for x in args[:4]), plan.cth,
            plan.ln_sth, plan.logc[m0:m1].contiguous(), args[7])
    for launch in (TL.analysis_cuda, TL.analysis_dot_cuda):
        first = launch(*args, plan.nl)
        second = launch(*args, plan.nl)
        block = launch(*rows, plan.nl, m0)
        for a, b, c in zip(first, second, block):
            assert torch.equal(a, b)
            assert torch.equal(c, a[m0:m1])
            assert bool(a.abs().max() > 0)


def test_add_at_on_the_card_equals_the_cpu(cuda_device):
    """ops/deposit.add_at on the card, on many values per element (where
    the order of a float32 sum shows): two calls give the same bits, and
    the same bits as on the CPU (both sum each element's values one after
    another in input order); the same for a [7, n] add along dim 1, as the
    lens maps use it.  index_add_ on the card would add them with atomics,
    in no fixed order."""
    from calclens_tpu_torch.ops.deposit import add_at

    rng = np.random.default_rng(21)
    n, targets = 1 << 20, 1000
    idx = torch.tensor(rng.integers(0, targets, n))
    vals = torch.tensor(rng.lognormal(0.0, 3.0, n).astype(np.float32))
    ref = add_at(torch.zeros(targets), idx, vals)
    on = [add_at(torch.zeros(targets, device=cuda_device),
                 idx.to(cuda_device), vals.to(cuda_device)).cpu()
          for _ in range(2)]
    assert torch.equal(on[0], on[1]) and torch.equal(on[0], ref)
    vals7 = torch.tensor(rng.normal(size=(7, n)).astype(np.float32))
    ref7 = add_at(torch.zeros(7, targets), idx, vals7, dim=1)
    got7 = add_at(torch.zeros(7, targets, device=cuda_device),
                  idx.to(cuda_device), vals7.to(cuda_device), dim=1).cpu()
    assert torch.equal(got7, ref7)


@pytest.mark.parametrize("lmax,rings", [(1000, 1024), (777, 700)])
def test_analysis_kernel_ragged_degrees_and_rings(cuda_device, lmax, rings):
    """K1 (and K4) at band limits whose nl - m takes every residue of
    K1's 16-degree sums, on all of order 9's ring pairs and on a ragged 700
    of them, with a forced cutoff (tile 0 cut at m = 40, tile 1 at 700)
    and with the rule's."""
    plan = SHTPlan(9, cuda_device, lmax=lmax, dtype=torch.float32)
    rng = np.random.default_rng(lmax)
    E, O = (torch.tensor((rng.normal(size=(plan.nm, rings))
                          + 1j * rng.normal(size=(plan.nm, rings))
                          ).astype(np.complex64), device=cuda_device)
            for _ in range(2))
    planes = [x.contiguous() for x in (E.real, E.imag, O.real, O.imag)]
    geo = tuple(x[:rings].contiguous()
                for x in (plan.cth, plan.ln_sth)) + (plan.logc,)
    rule = torch.as_tensor(TL.analysis_mcut(plan.sth_host[:rings], plan.nl,
                                            plan.nm), device=cuda_device)
    forced = torch.tensor([40, 700], dtype=torch.int32, device=cuda_device)
    for mcut in (rule, forced):
        rre, rim = TL.analysis_plain(*planes, *geo, mcut, plan.nl)
        for launch in (TL.analysis_cuda, TL.analysis_dot_cuda):
            re, im = launch(*planes, *geo, mcut, plan.nl)
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
            TL.synth_columns(streams, plan.cth, plan.ln_sth, plan.logc,
                             plan.mcut(TL.SYNTH_TILE_J))
    with pytest.raises(TypeError, match="float32 only"):
        TL.synth_vpu_columns(s, s, plan.cth, plan.sth, plan.cot,
                             plan.inv_sth, True, plan.mcut(TL.SYNTH_TILE_J))
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


def _gather_rows_into(tab, idx, rows):
    """gather_rows' launcher into a [rows, F] buffer of 7.0 (rows >= n)."""
    out = torch.full((rows, G.F), 7.0, device=tab.device)
    _ext.check(_ext.lib().gather_rows_launch(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), len(idx),
        torch.cuda.current_stream().cuda_stream), "gather_rows")
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("n", [1, 3, 31, 32, 33, 127, 129, (1 << 16) + 17])
def test_gather_rows_ragged_counts_bit_exact(cuda_device, n):
    """P2 writes 16 rows per store instruction from batches of 32 indices
    per warp: counts below, at and past a batch, and many batches with a
    ragged last one, equal tab[idx] bit for bit, and nothing past n is
    written."""
    tab, idx = G.inputs(n=n, seed=n, device=cuda_device)
    got = G.gather_rows(tab, idx)
    torch.cuda.synchronize()
    assert got.shape == (n, G.F)
    assert torch.equal(got, tab[idx])
    assert torch.equal(got, G.gather_rows_plain(tab, idx))
    out = _gather_rows_into(tab, idx, n + 40)
    assert torch.equal(out[:n], got)
    assert bool((out[n:] == 7.0).all())


def test_gather_rows_unaligned_index_view(cuda_device):
    """P2 on idx[1:] (4 bytes past a 16-byte boundary) gathers the view's
    rows."""
    tab, idx = G.inputs(n=(1 << 16) + 18, seed=5, device=cuda_device)
    view = idx[1:]
    assert view.data_ptr() % 16 != 0
    got = G.gather_rows(tab, view)
    torch.cuda.synchronize()
    assert torch.equal(got, tab[view])


def test_gather_rows_out_of_range_rows_are_nan(cuda_device):
    """Indices below 0 or at and past the table's 4096 rows give rows of
    NaN in P2, in either half of a store's 16 rows and in either batch;
    the other rows are still tab[idx]."""
    tab, idx = G.inputs(n=200, seed=12, device=cuda_device)
    bad = torch.tensor([0, 15, 16, 31, 32, 63, 199], device=cuda_device)
    idx[bad] = torch.tensor([-1, G.W, -(1 << 31), (1 << 31) - 1, G.W + 128,
                             -129, G.W], dtype=torch.int32,
                            device=cuda_device)
    ok = torch.ones(len(idx), dtype=torch.bool, device=cuda_device)
    ok[bad] = False
    got = G.gather_rows(tab, idx)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[~ok]).all())
    assert torch.equal(got[ok], tab[idx[ok]])


@pytest.mark.parametrize("n", [1, 63, 64, 65, (1 << 16) + 17])
def test_gather_onehot_ragged_counts_bit_exact(cuda_device, n):
    """P4 takes 64 indices per warpgroup product: counts below, at and past
    one group, and many groups with a ragged last one, equal tab[idx] bit
    for bit, and nothing past n is written."""
    tab, idx = G.inputs(n=n, seed=n, device=cuda_device)
    got = G.gather_onehot(tab, idx)
    torch.cuda.synchronize()
    assert got.shape == (n, G.F)
    assert torch.equal(got, tab[idx])
    assert torch.equal(got, G.gather_onehot_plain(tab, idx))


def test_gather_onehot_out_of_range_rows_are_nan(cuda_device):
    """Indices below 0 or at and past the table's 4096 rows give rows of
    NaN in P4, wherever they fall in a group of 64; the other rows are
    still tab[idx]."""
    tab, idx = G.inputs(n=200, seed=11, device=cuda_device)
    bad = torch.tensor([0, 31, 63, 64, 127, 199], device=cuda_device)
    idx[bad] = torch.tensor([-1, G.W, -(1 << 31), (1 << 31) - 1, G.W + 128,
                             -129], dtype=torch.int32, device=cuda_device)
    ok = torch.ones(len(idx), dtype=torch.bool, device=cuda_device)
    ok[bad] = False
    got = G.gather_onehot(tab, idx)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[~ok]).all())
    assert torch.equal(got[ok], tab[idx[ok]])


def test_gather_onehot_runs_on_wgmma(cuda_device):
    """P4's kernel in the built library holds wgmma (HGMMA) and no
    mma.sync (HMMA)."""
    route = G.onehot_route_sass()
    assert route["HGMMA"] > 0 and route["HMMA"] == 0, route


def test_roofline_probe_sass_keeps_stores_and_a_lean_rec_loop(cuda_device):
    """The timed rec+store loop stores a float per FADD; the timed rec
    loop issues fewer than 5 instructions per element (4 are the
    recurrence's)."""
    st = R.store_loop_check()
    assert st["stored_floats"] >= st["ops"].get("FADD", 0) > 0, st
    assert R.rec_loop_sass()["per_element"] < 5


@pytest.mark.parametrize("shape", [dict(MT=3, LBLK=3, LB=5, TM=16, TJ=32),
                                   dict(MT=2, LBLK=2, LB=32, TM=8, TJ=64)])
@pytest.mark.parametrize("mode", ["rec", "rec+store", "store", "dot"])
def test_roofline_probe_rows_shared_by_a_warp(cuda_device, mode, shape):
    """P1 where a warp spans 4 or 2 rows of m (TJ 32, 64), one degree at a
    time (odd LB) and in groups of 16 (LB 32), against its plain version:
    1e-6 of max |plain|, dot 1e-5 (another summation order)."""
    geo = R.default_geo(shape["TJ"], cuda_device)
    got = R.probe(geo=geo, mode=mode, **shape)
    torch.cuda.synchronize()
    ref = R.probe_plain(geo=geo, mode=mode, **shape)
    assert got.shape == ref.shape and bool(torch.isfinite(ref).all())
    assert _relerr(got, ref) <= (1e-5 if mode == "dot" else 1e-6)


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
