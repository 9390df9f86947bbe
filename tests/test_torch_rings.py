"""The port's ring stages (calclens_tpu_torch.sht.rings and czt, and the
synthesis_rings_mode / use_rings_v2 switches of sht.transforms) against the
JAX package's same modes on the same numpy inputs, and the tables they keep.

Tolerances, relative to the reference's max |value|: float64 1e-10 for the
syntheses (the JAX package's own bound between its modes,
tests/test_rings_v2.py) and 1e-11 for the analyses; float32 1e-5 (a length
2P chirp-Z rounds ~log2(2P) times per value).  The float32 phase table is
held to float64 instead: the port reduces m * shift mod 2n in integers, the
JAX RingStage forms m * shift / n in float, so the port's float32 result
must lie no farther from float64 than the JAX package's float32 result."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu.sht import transforms as JT
from calclens_tpu.sht.plan import SHTPlan as JPlan
from calclens_tpu.sht.rings import RingStage as JRingStage
from calclens_tpu_torch.sht import czt as tczt
from calclens_tpu_torch.sht import transforms as T
from calclens_tpu_torch.sht.plan import (DEFAULT_SYNTHESIS_RINGS_MODE,
                                         SYNTHESIS_RINGS_MODES, SHTPlan)

F64 = (np.float64, torch.float64, jnp.float64, 1e-10)
F32 = (np.float32, torch.float32, jnp.float32, 1e-5)
MODES = ("uniform", "v2")

_JPLANS = {}


def _jplan(order, jdt):
    """JAX plans shared across the module (their jitted pieces compile once
    per plan object); the mode is set by each test."""
    jp = _JPLANS.get((order, jdt))
    if jp is None:
        jp = _JPLANS[(order, jdt)] = JPlan(order, dtype=jdt)
        jp.use_pallas = False
    return jp


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _streams(plan, seed, cdt, nstreams=2):
    """Seeded q rows [nstreams, nrings_pad, nm] with zero padding rows (as
    unfold_pairs writes them)."""
    rng = np.random.default_rng(seed)
    shape = (nstreams, plan.nrings_pad, plan.nm)
    Q = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    Q[:, plan.nrings:] = 0.0
    return Q.astype(cdt)


@pytest.mark.parametrize("bad", ["bucketed", "hybrid"])
def test_modes_and_default(bad):
    """The two ported modes and the default; any other mode raises, the
    JAX package's "hybrid" (not ported) among them."""
    assert SYNTHESIS_RINGS_MODES == MODES
    plan = SHTPlan(3, "cpu", dtype=torch.float64)
    assert plan.synthesis_rings_mode == DEFAULT_SYNTHESIS_RINGS_MODE
    assert plan.use_rings_v2 is True
    plan.synthesis_rings_mode = bad
    with pytest.raises(ValueError, match="synthesis_rings_mode"):
        T.synthesis_rings(plan, torch.zeros((1, plan.nrings_pad, plan.nm),
                                            dtype=torch.complex128))


@pytest.mark.parametrize("prec", [F64, F32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", [3, 6])
def test_synthesis_rings_mode_matches_jax(order, mode, prec):
    ndt, tdt, jdt, tol = prec
    cdt = np.complex128 if ndt == np.float64 else np.complex64
    jp = _jplan(order, jdt)
    jp.synthesis_rings_mode = mode
    tp = SHTPlan(order, "cpu", dtype=tdt)
    tp.synthesis_rings_mode = mode
    Q = _streams(tp, 30 + order, cdt)
    ref = np.asarray(JT.synthesis_rings(jp, jnp.asarray(Q)))
    got = T.synthesis_rings(tp, torch.tensor(Q)).numpy()
    assert got.shape == ref.shape == (2, tp.npix)
    assert got.dtype == ndt
    assert _relerr(got, ref) < tol


@pytest.mark.parametrize("prec", [(*F64[:3], 1e-11), F32])
@pytest.mark.parametrize("order", [3, 6])
def test_uniform_analysis_matches_jax(order, prec):
    """use_rings_v2 = False: the uniform chirp-Z analysis over all rings,
    in both packages; with True the port's bucketed analysis agrees with
    the JAX uniform one as well (no cutoff bites at these orders)."""
    ndt, tdt, jdt, tol = prec
    jp = _jplan(order, jdt)
    jp.use_rings_v2 = False
    tp = SHTPlan(order, "cpu", dtype=tdt)
    tp.use_rings_v2 = False
    m = np.random.default_rng(40 + order).normal(size=(2, tp.npix))
    m = m.astype(ndt)
    try:
        ref = np.asarray(JT.analysis_rings(jp, jnp.asarray(m)))
    finally:
        jp.use_rings_v2 = True
    got = T.analysis_rings(tp, torch.tensor(m)).numpy()
    assert got.shape == ref.shape == (2, tp.nrings_pad, tp.nm)
    assert _relerr(got, ref) < tol
    tp.use_rings_v2 = True
    assert _relerr(T.analysis_rings(tp, torch.tensor(m)).numpy(), ref) < tol


@pytest.mark.parametrize("mode", MODES)
def test_alm2allmaps_and_alm2map_under_each_mode_match_jax(mode):
    order = 5
    jp = _jplan(order, jnp.float64)
    jp.synthesis_rings_mode = mode
    tp = SHTPlan(order, "cpu", dtype=torch.float64)
    tp.synthesis_rings_mode = mode
    rng = np.random.default_rng(50)
    l = np.arange(tp.nl)[:, None]
    mm = np.arange(tp.nm)[None, :]
    alm = np.where(mm <= l, rng.normal(size=(tp.nl, tp.nm))
                   + 1j * rng.normal(size=(tp.nl, tp.nm)), 0.0)
    alm[:, 0] = alm[:, 0].real
    ref = np.stack([np.asarray(x) for x in
                    JT.alm2allmaps(jp, jnp.asarray(alm))])
    got = T.alm2allmaps(tp, torch.tensor(alm)).numpy()
    for k in range(6):
        assert _relerr(got[k], ref[k]) < 1e-10, k
    ref_phi = np.asarray(JT.alm2map(jp, jnp.asarray(alm)))
    got_phi = T.alm2map(tp, torch.tensor(alm)).numpy()
    assert _relerr(got_phi, ref_phi) < 1e-10


@pytest.mark.parametrize("mode", MODES)
def test_padding_rows_are_zero_and_never_read(mode):
    """unfold_pairs writes zero padding rows; whatever they hold, no mode's
    maps change (v2 points its padding and empty fold entries at the last
    padding ring, which it zeroes)."""
    tp = SHTPlan(4, "cpu", dtype=torch.float64)
    tp.synthesis_rings_mode = mode
    rng = np.random.default_rng(60)
    qN = torch.tensor(rng.normal(size=(tp.nm, tp.J))
                      + 1j * rng.normal(size=(tp.nm, tp.J)))
    qS = torch.tensor(rng.normal(size=(tp.nm, tp.J))
                      + 1j * rng.normal(size=(tp.nm, tp.J)))
    Q = T.unfold_pairs(tp, qN, qS)
    assert tp.nrings_pad > tp.nrings
    assert torch.count_nonzero(Q[tp.nrings:]) == 0
    ref = T.synthesis_rings(tp, Q[None])
    junk = Q.clone()
    junk[tp.nrings:] = 7.0 + 3.0j
    assert torch.equal(T.synthesis_rings(tp, junk[None]), ref)
    assert torch.count_nonzero(junk[tp.nrings:]) > 0  # input left as it was


def test_second_call_builds_no_table():
    """Every table of the ring stages (chirp tables, phase tables, the
    analysis masks, the fold, assembly, rings_to_map and m mod n indices)
    is built in the first call of its mode and reused after: a second call
    builds nothing and hands out the same tensors."""
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    rng = np.random.default_rng(70)
    Q = torch.tensor(_streams(tp, 71, np.complex64))
    m = torch.tensor(rng.normal(size=tp.npix).astype(np.float32))

    def run_all():
        for mode in MODES:
            tp.synthesis_rings_mode = mode
            T.synthesis_rings(tp, Q)
        for v2 in (True, False):
            tp.use_rings_v2 = v2
            T.analysis_rings(tp, m)

    run_all()
    builds = tp.tables.builds
    kept = dict(tp.tables._tables)
    kinds = {k[0] for k in kept}
    assert kinds == {"czt", "synthesis_phase", "ring_phase", "rings_to_map",
                     "map_to_rings", "m_mod_n", "phase_analysis",
                     "analysis_mask", "fold", "assembly"}
    assert all(tp.tables.nbytes(k) > 0 for k in kinds)
    run_all()
    assert tp.tables.builds == builds
    assert tp.tables._tables.keys() == kept.keys()
    assert all(tp.tables._tables[k] is kept[k] for k in kept)


@pytest.mark.parametrize("order", [3, 5])
def test_cached_czt_equals_czt_bit_for_bit(order):
    """The uniform synthesis chirp-Z with tables gathered from the distinct
    ring lengths equals the chirp-Z with tables built for every row, block
    by block, bit for bit."""
    tp = SHTPlan(order, "cpu", dtype=torch.float32)
    Y = torch.tensor(_streams(tp, 80 + order, np.complex64))
    got = tczt.czt_blocked(Y, tp.n_host, tp.P, tp.L, +1, tp.cdtype,
                           tp.ring_block, tp.tables, "uniform", real=True)
    ref = torch.cat([
        tczt.czt(Y[..., i: i + tp.ring_block, :], tp.P, tczt.czt_tables(
            tp.n_dev[i: i + tp.ring_block], tp.nm, tp.P, tp.L, +1,
            tp.cdtype)).real
        for i in range(0, tp.nrings_pad, tp.ring_block)], dim=-2)
    assert torch.equal(got, ref)
    w, Vf, rows = tp.tables.chirp("uniform", tp.n_host, tp.nm, tp.P, tp.L,
                                  +1, tp.cdtype)
    # ring lengths 4, 8, ..., 4 nside (the padding rings' 4 among them)
    assert len(w) == len(np.unique(tp.n_host)) == tp.nside


def test_float32_phase_no_worse_than_jax():
    """The v2 synthesis in float32 against a float64 run: the port's (phase
    reduced mod 2n in integers) lies no farther from float64 than the JAX
    package's (phase formed in float); so do their phase tables."""
    order = 6
    tp32 = SHTPlan(order, "cpu", dtype=torch.float32)
    Q = _streams(tp32, 90, np.complex128, nstreams=1)
    rs64 = JRingStage(order, tp32.nm, tp32.nrings_pad, dtype=jnp.float64)
    rs32 = JRingStage(order, tp32.nm, tp32.nrings_pad, dtype=jnp.float32)
    ref = np.asarray(rs64.synthesis(jnp.asarray(Q)))
    jax32 = np.asarray(rs32.synthesis(jnp.asarray(Q.astype(np.complex64))))
    tp32.synthesis_rings_mode = "v2"
    port32 = T.synthesis_rings(tp32, torch.tensor(Q.astype(np.complex64)))
    assert _relerr(port32.numpy(), ref) <= _relerr(jax32, ref)
    wfold = np.where(np.arange(tp32.nm) == 0, 1.0, 2.0)
    ph64 = np.asarray(rs64._phase(+1)) * wfold
    err_jax = np.abs(np.asarray(rs32._phase(+1)) * wfold - ph64).max()
    err_port = np.abs(tp32.synthesis_phase().numpy() - ph64).max()
    assert err_port < err_jax
    # the phase argument t pi / n < 2 pi rounds to ~4e-7 rad in float32,
    # times the weight 2
    assert err_port < 2e-6


def test_ring_stage_buckets_match_jax():
    """The port's RingStage builds the JAX package's synthesis buckets and
    row bases (piece_base, total_len) and analysis groups."""
    order = 6
    tp = SHTPlan(order, "cpu", dtype=torch.float64)
    jrs = JRingStage(order, tp.nm, tp.nrings_pad, dtype=jnp.float64)
    trs = tp.ring_stage()
    assert len(trs.buckets) == len(jrs.buckets) > 1
    for a, b in zip(trs.buckets, jrs.buckets):
        np.testing.assert_array_equal(a["rows"], b["rows"])
        assert (a["nmax"], a["rows_pad"], a["L"]) == (b["nmax"], b["rows_pad"],
                                                      b["L"])
        np.testing.assert_array_equal(a["n"], b["n"])
    np.testing.assert_array_equal(trs.piece_base, jrs.piece_base)
    assert trs.total_len == jrs.total_len
    assert [(b["K"], b["L"], b["Nk"]) for b in trs.abuckets] == \
        [(b["K"], b["L"], b["Nk"]) for b in jrs.abuckets]
