"""Parity of the port's alternative Legendre kernels and of alm2map with
the JAX package on the same numpy inputs: the plain twins of K3 (bucketed
synthesis), K4 (stored-lambda analysis) and K2's 4-column form against the
Pallas kernels they replace, run as the JAX package's own tests run them on
the CPU (TPU interpret mode; order 4, TM=8, TJ=128, LB=16 as in
tests/test_pallas_legendre.py), and the potential-only SHT against the JAX
scan path.

Tolerances, relative to each stream's max |reference|: 1e-5 for float32
twin against Pallas kernel (both round the recurrence in float32 from the
same seed; they differ in the order of the sums); 1e-10 for float64 against
the JAX scan (other summation orders, another lambda_mm seed)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from calclens_tpu.sht import pallas_legendre as PL
from calclens_tpu.sht import pallas_legendre_mx as MX
from calclens_tpu.sht import transforms as JT
from calclens_tpu.sht.plan import SHTPlan as JPlan
from calclens_tpu_torch.sht import legendre as TL
from calclens_tpu_torch.sht import transforms as T
from calclens_tpu_torch.sht.plan import SHTPlan

TM, TJ, LB = 8, 128, 16


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _random_alm(nl, nm, seed, cdt):
    rng = np.random.default_rng(seed)
    l = np.arange(nl)[:, None]
    m = np.arange(nm)[None, :]
    alm = np.where(m <= l, rng.normal(size=(nl, nm))
                   + 1j * rng.normal(size=(nl, nm)), 0.0)
    alm[:, 0] = alm[:, 0].real
    return alm.astype(cdt)


def _jplan(order, jdt=jnp.float32):
    jp = JPlan(order, dtype=jdt)
    jp.use_pallas = False
    return jp


@pytest.mark.parametrize("derivs", [True, False])
def test_k3_twin_matches_pallas_bucket_kernel(derivs):
    """The buckets' (qN, qS) against synthesis_pallas, and the twin's raw
    buckets against the kernel's own through the same post-processing."""
    jp = _jplan(4)
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    alm = _random_alm(tp.nl, tp.nm, 30 + derivs, np.complex64)
    with pltpu.force_tpu_interpret_mode():
        qN_ref, qS_ref = PL.synthesis_pallas(jp, jnp.asarray(alm), derivs,
                                             TM=TM, TJ=TJ, LB=LB)
    a_re, a_im = TL.mx_prep(tp.nl, tp.nm, torch.tensor(alm), torch.float32,
                            derivs=False)
    c = TL.synth_vpu_plain(a_re, a_im, tp.cth, tp.sth, tp.cot, tp.inv_sth,
                           derivs)
    assert c.shape == (tp.nm, 12 if derivs else 4, tp.J)
    qN, qS = TL.q_from_buckets(tp, c)
    assert qN.shape == qS.shape == (3 if derivs else 1, tp.nm, tp.J)
    for k in range(qN.shape[0]):
        assert _relerr(qN[k].numpy(), qN_ref[k]) < 1e-5, k
        assert _relerr(qS[k].numpy(), qS_ref[k]) < 1e-5, k
    # the dispatcher reaches the same twin
    tp.synth_kernel = "k3"
    qN2, qS2 = T.legendre_synthesis(tp, torch.tensor(alm), derivs)
    np.testing.assert_array_equal(qN2.numpy(), qN.numpy())
    np.testing.assert_array_equal(qS2.numpy(), qS.numpy())


def test_k3_chain_seed_rows_match_full_table():
    """The seed chain: row selection gives the full table's rows, and the
    seed of m = 0 is 1/sqrt(4 pi)."""
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    full, fk = TL.chain_seed(torch.arange(tp.nm), tp.sth)
    some = torch.tensor([0, 7, tp.nm - 1])
    part, pk = TL.chain_seed(some, tp.sth)
    np.testing.assert_array_equal(part.numpy(), full[some].numpy())
    np.testing.assert_array_equal(pk.numpy(), fk[some].numpy())
    np.testing.assert_array_equal(full[0].numpy(),
                                  np.float32(0.28209479177387814))


@pytest.mark.parametrize("order", [4, 6])
def test_k3_seed_table_rows_match_chain_seed(order):
    """The seed table that K3's pre-pass computes, the chain walked once
    over every m < nm (chain_seed of all rows), equals chain_seed of each
    row's m alone, row by row, bit for bit."""
    tp = SHTPlan(order, "cpu", dtype=torch.float32)
    seed, seed_k = TL.chain_seed(torch.arange(tp.nm), tp.sth)
    assert seed.shape == seed_k.shape == (tp.nm, tp.J)
    assert seed.dtype == torch.float32 and seed_k.dtype == torch.int32
    for m in (0, 1, 2, tp.nm // 2, tp.nm - 1):
        v, k = TL.chain_seed(torch.tensor([m]), tp.sth)
        assert torch.equal(seed[m], v[0]) and torch.equal(seed_k[m], k[0]), m
    # far from the equator the chain underflows into its scale counter
    assert int(seed_k[-1, 0]) < 0


@pytest.mark.parametrize("order", [3, 4, 5, 6, 7])
def test_k3_seed_segments_match_chain_seed(order):
    """K3's seed pre-pass as plain PyTorch (chain_seed_segmented: the
    producers' scaled walk with checkpoints, then each segment re-walked)
    equals chain_seed bit for bit, values and counters, at several segment
    lengths, including the kernel's and lengths that do not divide nm."""
    tp = SHTPlan(order, "cpu", dtype=torch.float32)
    ref, ref_k = TL.chain_seed(torch.arange(tp.nm), tp.sth)
    for seg in (1, 7, 32, TL.SEED_SEGMENT):
        got, got_k = TL.chain_seed_segmented(tp.sth, tp.nm, seg)
        assert torch.equal(got, ref) and torch.equal(got_k, ref_k), seg
    assert int(ref_k.min()) < 0  # the rescale is exercised


def test_k3_seed_segments_on_extreme_rings():
    """The same on rings the scaled walk takes (sin theta down to 2^-40,
    and 1) and rings it leaves to the plain chain (0, just below 2^-40),
    over nm = 700 degrees (not a multiple of the segment), with rescales
    falling on segment edges."""
    rng = np.random.default_rng(8)
    s = np.exp2(rng.uniform(-45.0, 0.0, 400)).astype(np.float32)
    s[:4] = 1.0
    s[4:6] = 0.0
    s[6:8] = np.float32(2.0**-40)
    s[8:10] = np.nextafter(np.float32(2.0**-40), np.float32(0.0))
    sth = torch.tensor(s)
    nm = 700
    ref, ref_k = TL.chain_seed(torch.arange(nm), sth)
    seg = TL.SEED_SEGMENT
    edge = ref_k[seg] != ref_k[seg - 1]
    assert bool(edge[10:].any())  # a scaled ring rescales at the first edge
    got, got_k = TL.chain_seed_segmented(sth, nm, seg)
    assert torch.equal(got, ref) and torch.equal(got_k, ref_k)


def test_k4_twin_matches_pallas_dot_kernel():
    jp = _jplan(4)
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    E, O = ((rng.normal(size=(tp.nm, tp.J))
             + 1j * rng.normal(size=(tp.nm, tp.J))).astype(np.complex64)
            for _ in range(2))
    prev = PL._ANA_DOT
    PL._ANA_DOT = True
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = PL.analysis_pallas(jp, jnp.asarray(E), jnp.asarray(O),
                                     TM=TM, TJ=TJ, LB=LB)
    finally:
        PL._ANA_DOT = prev
    tp.analysis_kernel = "k4"
    got = T.legendre_analysis(tp, torch.tensor(E), torch.tensor(O)).numpy()
    assert got.shape == (tp.nl, tp.nm)
    assert _relerr(got, ref) < 1e-5
    # K4 computes K1's function: the two twins agree to the sums' order
    tp.analysis_kernel = "k1"
    k1 = T.legendre_analysis(tp, torch.tensor(E), torch.tensor(O)).numpy()
    assert _relerr(got, k1) < 1e-6


def test_k4_twin_honours_tile_cutoff_and_rows():
    """A forced per-tile cutoff and a subset of m rows: K4's twin gives
    K1's twin's values (rows restrict the computation, not the result)."""
    tp = SHTPlan(5, "cpu", dtype=torch.float64)
    rng = np.random.default_rng(3)
    planes = [torch.tensor(rng.normal(size=(tp.nm, tp.J))) for _ in range(4)]
    mcut = torch.tensor([20, 5], dtype=torch.int32)  # two 32-ring tiles
    args = (*planes, tp.cth, tp.ln_sth, tp.logc, mcut, tp.nl)
    r1, i1 = TL.analysis_plain(*args, tile_j=32)
    r4, i4 = TL.analysis_dot_plain(*args, tile_j=32)
    assert _relerr(r4, r1) < 1e-12 and _relerr(i4, i1) < 1e-12
    rows = torch.tensor([0, 3, 19, 20, 40])
    sub = [p[rows] for p in planes]
    rr, ri = TL.analysis_dot_plain(*sub, tp.cth, tp.ln_sth, tp.logc[rows],
                                   mcut, tp.nl, tile_j=32, m=rows)
    assert _relerr(rr, r1[rows]) < 1e-12 and _relerr(ri, i1[rows]) < 1e-12
    assert float(r1[20].abs().max()) == 0.0  # m = 20 cut in both tiles


def test_k2_four_columns_match_pallas_mx_kernel():
    """K2's 4-column twin against the Pallas MXU kernel with ncol = 4, and
    its (qN, qS) against synthesis_pallas_mx(..., derivs=False)."""
    jp = _jplan(4)
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    alm = _random_alm(tp.nl, tp.nm, 40, np.complex64)
    nm_pad = -(-tp.nm // TM) * TM
    nl_pad = -(-tp.nl // LB) * LB
    J_pad = -(-tp.J // TJ) * TJ
    prepped = MX.mx_prep(tp.nl, tp.nm, jnp.asarray(alm), False, TM=TM, LB=LB)
    key = (nl_pad, nm_pad, J_pad, LB, TM, TJ, 8, MX._MX_CORFAC_SKIP,
           MX._MX_BATCHED_DOT)
    with pltpu.force_tpu_interpret_mode():
        raw = MX._synth_mx_raw(key, *prepped, MX._geo_rows(jp, J_pad), 4)
        qN_ref, qS_ref = MX.synthesis_pallas_mx(jp, jnp.asarray(alm), False,
                                                TM=TM, TJ=TJ, LB=LB)
    raw = np.asarray(raw)[: tp.nm, :, : tp.J]
    streams = TL.mx_prep(tp.nl, tp.nm, torch.tensor(alm), torch.float32,
                         derivs=False)
    assert len(streams) == 2
    cols = TL.synth_plain(streams, tp.cth, tp.ln_sth, tp.logc)
    assert cols.shape == (tp.nm, 4, tp.J)
    for c in range(4):
        assert _relerr(cols[:, c].numpy(), raw[:, c]) < 1e-5, c
    qN, qS = TL.q_from_columns(tp, cols)
    assert qN.shape == (1, tp.nm, tp.J)
    assert _relerr(qN[0].numpy(), qN_ref[0]) < 1e-5
    assert _relerr(qS[0].numpy(), qS_ref[0]) < 1e-5
    # the 4 columns are the potential columns of the 16
    full = TL.synth_plain(TL.mx_prep(tp.nl, tp.nm, torch.tensor(alm),
                                     torch.float32), tp.cth, tp.ln_sth,
                          tp.logc)
    np.testing.assert_array_equal(cols[:, :2].numpy(), full[:, :2].numpy())
    np.testing.assert_array_equal(cols[:, 2:].numpy(), full[:, 8:10].numpy())


@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_q_of_rows_matches_rows_of_q(kernel):
    """The post-processing of a subset of m rows gives those rows of the
    full (qN, qS); in float64 the twins of K2 (direct seed) and K3 (seed
    chain) agree to 1e-12 of each quantity's max on those rows."""
    tp = SHTPlan(5, "cpu", dtype=torch.float64)
    alm = torch.tensor(_random_alm(tp.nl, tp.nm, 60, np.complex128))
    s = TL.mx_prep(tp.nl, tp.nm, alm, torch.float64)
    rows = torch.tensor([0, 1, 6, 31, tp.nm - 1])
    sub = tuple(x[rows] for x in s)
    if kernel == "k2":
        full = TL.q_from_columns(tp, TL.synth_plain(s, tp.cth, tp.ln_sth,
                                                    tp.logc))
        part = TL.q_from_columns(tp, TL.synth_plain(
            sub, tp.cth, tp.ln_sth, tp.logc[rows], m=rows), m=rows)
        other = TL.q_from_buckets(tp, TL.synth_vpu_plain(
            sub[0], sub[1], tp.cth, tp.sth, tp.cot, tp.inv_sth, True,
            m=rows), m=rows)
    else:
        g = (tp.cth, tp.sth, tp.cot, tp.inv_sth, True)
        full = TL.q_from_buckets(tp, TL.synth_vpu_plain(s[0], s[1], *g))
        part = TL.q_from_buckets(tp, TL.synth_vpu_plain(
            sub[0], sub[1], *g, m=rows), m=rows)
        other = TL.q_from_columns(tp, TL.synth_plain(
            sub, tp.cth, tp.ln_sth, tp.logc[rows], m=rows), m=rows)
    for h in (0, 1):
        assert part[h].shape == (3, len(rows), tp.J)
        for k in range(3):
            assert _relerr(part[h][k], full[h][k][rows]) < 1e-14, (h, k)
            assert _relerr(other[h][k], part[h][k]) < 1e-12, (h, k)


@pytest.mark.parametrize("order,prec", [
    (4, (np.float64, torch.float64, jnp.float64, 1e-10)),
    (5, (np.float32, torch.float32, jnp.float32, 1e-5)),
    (6, (np.float64, torch.float64, jnp.float64, 1e-10))])
@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_alm2map_matches_jax(order, prec, kernel):
    ndt, tdt, jdt, tol = prec
    cdt = np.complex128 if ndt == np.float64 else np.complex64
    jp = _jplan(order, jdt)
    tp = SHTPlan(order, "cpu", dtype=tdt)
    tp.synth_kernel = kernel
    alm = _random_alm(tp.nl, tp.nm, 50 + order, cdt)
    ref = np.asarray(JT.alm2map(jp, jnp.asarray(alm)))
    got = T.alm2map(tp, torch.tensor(alm)).numpy()
    assert got.shape == ref.shape == (tp.npix,)
    assert _relerr(got, ref) < tol


def test_selectors_default_env_and_refusal(monkeypatch):
    """K2/K1 by default; CALCLENS_ANA_DOT=1 at plan build selects K4, as it
    does for the JAX package; an unknown name raises."""
    tp = SHTPlan(2, "cpu", dtype=torch.float32)
    assert (tp.synth_kernel, tp.analysis_kernel) == ("k2", "k1")
    monkeypatch.setenv("CALCLENS_ANA_DOT", "1")
    assert SHTPlan(2, "cpu").analysis_kernel == "k4"
    alm = torch.zeros((tp.nl, tp.nm), dtype=torch.complex64)
    tp.synth_kernel = "k5"
    with pytest.raises(ValueError, match="synth_kernel"):
        T.legendre_synthesis(tp, alm)
    x = torch.zeros((tp.nm, tp.J), dtype=torch.complex64)
    tp.analysis_kernel = "mx"
    with pytest.raises(ValueError, match="analysis_kernel"):
        T.legendre_analysis(tp, x, x)
