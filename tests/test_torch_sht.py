"""Parity of the port's SHT (calclens_tpu_torch.sht) with calclens_tpu.sht on
the same numpy inputs, and of the two Legendre kernels' plain twins with the
Pallas kernels they replace (run as the JAX package's own tests run them on
the CPU: interpret mode).

Tolerances, relative to the reference's max |value|: float64 1e-10 (the two
packages sum in different orders and seed lambda_mm differently: a chain of
products in the JAX scan, log2 space in the twins); float32 1e-5 for the
analysis and the potential, 2e-5 for the derivative maps (their
summed-by-parts streams lose a further digit to cancellation)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from calclens_tpu.sht import czt as jczt
from calclens_tpu.sht import pallas_legendre as PL
from calclens_tpu.sht import pallas_legendre_mx as MX
from calclens_tpu.sht import transforms as JT
from calclens_tpu.sht.plan import SHTPlan as JPlan
from calclens_tpu_torch.sht import czt as tczt
from calclens_tpu_torch.sht import legendre as TL
from calclens_tpu_torch.sht import transforms as T
from calclens_tpu_torch.sht.plan import SHTPlan

F64 = (np.float64, torch.float64, jnp.float64, 1e-10)
F32 = (np.float32, torch.float32, jnp.float32, 1e-5)


_JPLANS = {}


def _plans(order, jdt, tdt):
    """(JAX plan, port plan).  JAX plans are shared across the module: its
    jitted scans compile once per plan object."""
    jp = _JPLANS.get((order, jdt))
    if jp is None:
        jp = _JPLANS[(order, jdt)] = JPlan(order, dtype=jdt)
        jp.use_pallas = False
    return jp, SHTPlan(order, "cpu", dtype=tdt)


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


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("prec", [F64, F32])
def test_czt_matches_jax(sign, prec):
    ndt, tdt, jdt, tol = prec
    cdt = np.complex128 if ndt == np.float64 else np.complex64
    rng = np.random.default_rng(3 + sign)
    n = np.array([4, 8, 12, 16, 20, 24, 28, 32], np.int32)
    N, K = 32, 40
    L = 80
    x = (rng.normal(size=(2, 8, N)) + 1j * rng.normal(size=(2, 8, N)))
    x[..., :] *= np.arange(N)[None, None, :] < n[None, :, None]
    x = x.astype(cdt)
    ref = np.asarray(jczt.czt(jnp.asarray(x), jnp.asarray(n), K, L, sign,
                              jnp.complex128 if ndt == np.float64
                              else jnp.complex64))
    got = tczt.czt(torch.tensor(x), torch.tensor(n), K, L, sign,
                   torch.complex128 if ndt == np.float64
                   else torch.complex64)
    assert _relerr(got.numpy(), ref) < tol
    blk = tczt.czt_blocked(torch.tensor(x), torch.tensor(n), K, L, sign,
                           got.dtype, block=4, real=True)
    assert _relerr(blk.numpy(), ref.real) < tol


@pytest.mark.parametrize("order,prec", [(4, F64), (5, F32)])
def test_analysis_rings_matches_jax(order, prec):
    ndt, tdt, jdt, tol = prec
    jp, tp = _plans(order, jdt, tdt)
    m = np.random.default_rng(order).normal(size=tp.npix).astype(ndt)
    ref = np.asarray(JT.analysis_rings(jp, jnp.asarray(m)))
    got = T.analysis_rings(tp, torch.tensor(m)).numpy()
    assert got.shape == ref.shape
    assert _relerr(got, ref) < tol


# orders 4-6 and both precisions; each case costs the JAX package several
# seconds of compilation on the CPU
SHT_CASES = [(4, F64), (5, F32), (6, F64)]


@pytest.mark.parametrize("order,prec", SHT_CASES)
def test_map2alm_matches_jax(order, prec):
    ndt, tdt, jdt, tol = prec
    jp, tp = _plans(order, jdt, tdt)
    m = np.random.default_rng(10 + order).normal(size=tp.npix).astype(ndt)
    ref = np.asarray(JT.map2alm(jp, jnp.asarray(m)))
    got = T.map2alm(tp, torch.tensor(m)).numpy()
    assert got.shape == ref.shape == (tp.nl, tp.nm)
    assert _relerr(got, ref) < tol


@pytest.mark.parametrize("order,prec", SHT_CASES)
def test_alm2allmaps_matches_jax(order, prec):
    ndt, tdt, jdt, tol = prec
    cdt = np.complex128 if ndt == np.float64 else np.complex64
    jp, tp = _plans(order, jdt, tdt)
    alm = _random_alm(tp.nl, tp.nm, 20 + order, cdt)
    ref = np.stack([np.asarray(x) for x in
                    JT.alm2allmaps(jp, jnp.asarray(alm))])
    got = T.alm2allmaps(tp, torch.tensor(alm)).numpy()
    assert got.shape == ref.shape == (6, tp.npix)
    for k in range(6):
        # derivative maps (k >= 1) carry the streams' ~1/l cancellation
        assert _relerr(got[k], ref[k]) < (tol if k == 0 else 2 * tol), k


@pytest.mark.parametrize("order,prec", [(4, F64), (5, F32)])
def test_legendre_twins_match_jax_scans(order, prec):
    """Both twins against the JAX package's plain scans (seed by a chain of
    products, no cutoff).  Each stream is scaled by its north ring's max, as
    tests/test_pallas_mx.py scales the Pallas kernel; the derivative streams
    get 3x the tolerance in float32 (the Pallas kernel, whose
    summed-by-parts math the twin shares, is 1.3e-5 off the scan on d_theta
    at order 5)."""
    ndt, tdt, jdt, tol = prec
    cdt = np.complex128 if ndt == np.float64 else np.complex64
    jp, tp = _plans(order, jdt, tdt)
    rng = np.random.default_rng(5)
    E, O = ((rng.normal(size=(tp.nm, tp.J))
             + 1j * rng.normal(size=(tp.nm, tp.J))).astype(cdt)
            for _ in range(2))
    ref = np.asarray(JT.legendre_analysis(jp, jnp.asarray(E), jnp.asarray(O)))
    got = T.legendre_analysis(tp, torch.tensor(E), torch.tensor(O)).numpy()
    assert _relerr(got, ref) < tol
    alm = _random_alm(tp.nl, tp.nm, 6, cdt)
    qN_ref, qS_ref = JT.legendre_synthesis(jp, jnp.asarray(alm), True)
    qN, qS = T.legendre_synthesis(tp, torch.tensor(alm), True)
    for k in range(3):
        sc = np.max(np.abs(np.asarray(qN_ref[k]))) * (
            tol if k == 0 or ndt == np.float64 else 3 * tol)
        assert np.max(np.abs(qN[k].numpy() - qN_ref[k])) < sc, k
        assert np.max(np.abs(qS[k].numpy() - qS_ref[k])) < sc, k


def test_synth_twin_matches_pallas_mx_kernel():
    """K2's twin against the Pallas MXU synthesis kernel in TPU interpret
    mode (order 4, TM=8, TJ=128, LB=16 as tests/test_pallas_mx.py): the 16
    raw columns and the (qN, qS) post-processing."""
    jp, tp = _plans(4, jnp.float32, torch.float32)
    alm = _random_alm(tp.nl, tp.nm, 0, np.complex64)
    TM, TJ, LB = 8, 128, 16
    nm_pad = -(-tp.nm // TM) * TM
    nl_pad = -(-tp.nl // LB) * LB
    J_pad = -(-tp.J // TJ) * TJ
    prepped = MX.mx_prep(tp.nl, tp.nm, jnp.asarray(alm), True, TM=TM, LB=LB)
    key = (nl_pad, nm_pad, J_pad, LB, TM, TJ, 8, MX._MX_CORFAC_SKIP,
           MX._MX_BATCHED_DOT)
    with pltpu.force_tpu_interpret_mode():
        raw = MX._synth_mx_raw(key, *prepped, MX._geo_rows(jp, J_pad), 16)
        qN_ref, qS_ref = MX.synthesis_pallas_mx(jp, jnp.asarray(alm), True,
                                                TM=TM, TJ=TJ, LB=LB)
    raw = np.asarray(raw)[: tp.nm, :, : tp.J]
    streams = TL.mx_prep(tp.nl, tp.nm, torch.tensor(alm), torch.float32)
    cols = TL.synth_plain(*streams, tp.cth, tp.ln_sth, tp.logc).numpy()
    assert cols.shape == (tp.nm, 16, tp.J)
    for c in range(16):
        assert _relerr(cols[:, c], raw[:, c]) < 1e-5, c
    qN, qS = TL.q_from_columns(tp, torch.tensor(cols))
    for k in range(3):
        assert _relerr(qN[k].numpy(), qN_ref[k]) < 1e-5, k
        assert _relerr(qS[k].numpy(), qS_ref[k]) < 1e-5, k


def test_analysis_twin_matches_pallas_kernel_with_forced_cutoffs():
    """K1's twin against the Pallas analysis kernel (generic interpreter,
    as tests/test_mcut.py) with a hand-forced per-j-tile cutoff: tile 0 cut
    at m = 16, tile 1 fully skipped, the rest full."""
    jp, tp = _plans(4, jnp.float32, torch.float32)
    rng = np.random.default_rng(11)
    nm, J, nl = tp.nm, tp.J, tp.nl
    E, O = ((rng.normal(size=(nm, J)) + 1j * rng.normal(size=(nm, J))
             ).astype(np.complex64) for _ in range(2))
    TM, TJ, LB = 8, 16, 16
    nm_pad = -(-nm // TM) * TM
    J_pad = -(-J // TJ) * TJ
    nl_pad = -(-nl // LB) * LB
    njt = J_pad // TJ
    mcuts = np.full(njt, nm, np.int32)
    mcuts[0] = 16
    mcuts[1] = 0

    def pad(x):
        out = np.zeros((nm_pad, J_pad), np.float32)
        out[:nm, :J] = x
        return jnp.asarray(out)

    geo = MX._geo_rows(jp, J_pad)
    logc = jnp.asarray(MX._logc_table(nm_pad))
    key = (nl_pad, nm_pad, J_pad, LB, TM, TJ, 8)
    almre, almim = PL._analysis_alm(
        key, jnp.asarray(mcuts[None, :]), pad(E.real), pad(E.imag),
        pad(O.real), pad(O.imag), geo, logc, nl, interpret=True)
    ref = (np.asarray(almre) + 1j * np.asarray(almim))[:nl, :nm]
    planes = [torch.tensor(np.ascontiguousarray(x)) for x in
              (E.real, E.imag, O.real, O.imag)]
    # the Pallas kernel skips whole m tiles: round each cutoff up to TM
    tile_cut = torch.tensor(-(-mcuts // TM) * TM, dtype=torch.int32)
    re, im = TL.analysis_plain(*planes, tp.cth, tp.ln_sth, tp.logc, tile_cut,
                               nl, tile_j=TJ)
    got = (re + 1j * im).T.numpy()
    assert _relerr(got, ref) < 1e-5


def test_analysis_cutoff_rule_matches_pallas_wrapper():
    """The per-tile cutoff is analysis_pallas's rule: m_cutoff at
    granularity 1 on each 512-ring tile's largest sin theta."""
    sth = np.sin(np.linspace(1e-3, np.pi / 2, 2048))
    nl = nm = 6144
    got = TL.analysis_mcut(sth, nl, nm)
    ref = [JT.m_cutoff(nl - 1, float(np.max(sth[t * 512:(t + 1) * 512])), nm,
                       granularity=1) for t in range(4)]
    np.testing.assert_array_equal(got, ref)
    assert got[0] < nm  # the polar tile is cut
    for lmax, s, nm_, g in [(767, 0.1, 768, 1), (12287, 0.01, 12288, 256),
                            (47, 1.0, 48, 512), (3071, 0.5, 3072, 512)]:
        assert T.m_cutoff(lmax, s, nm_, g) == JT.m_cutoff(lmax, s, nm_, g)


def test_fold_unfold_pairs_match_jax():
    jp, tp = _plans(4, jnp.float64, torch.float64)
    rng = np.random.default_rng(2)
    G = (rng.normal(size=(tp.nrings_pad, tp.nm))
         + 1j * rng.normal(size=(tp.nrings_pad, tp.nm)))
    Ej, Oj = JT.fold_pairs(jp, jnp.asarray(G))
    Et, Ot = T.fold_pairs(tp, torch.tensor(G))
    assert _relerr(Et.numpy(), Ej) < 1e-14 and _relerr(Ot.numpy(), Oj) < 1e-14
    qN = rng.normal(size=(tp.nm, tp.J)) + 1j * rng.normal(size=(tp.nm, tp.J))
    qS = rng.normal(size=(tp.nm, tp.J)) + 1j * rng.normal(size=(tp.nm, tp.J))
    np.testing.assert_array_equal(
        T.unfold_pairs(tp, torch.tensor(qN), torch.tensor(qS)).numpy(),
        np.asarray(JT.unfold_pairs(jp, jnp.asarray(qN), jnp.asarray(qS))))


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """The launchers never run a CPU tensor: the dispatching wrappers send
    CPU tensors to the twins, the kernel entry points raise."""
    tp = SHTPlan(2, "cpu", dtype=torch.float32)
    x = torch.zeros((tp.nm, tp.J))
    mcut = torch.tensor(TL.analysis_mcut(tp.sth_host, tp.nl, tp.nm))
    with pytest.raises(ValueError, match="not on CUDA"):
        TL.analysis_cuda(x, x, x, x, tp.cth, tp.ln_sth, tp.logc, mcut, tp.nl)
    s = torch.zeros((tp.nm, tp.nl))
    with pytest.raises(ValueError, match="not on CUDA"):
        TL.synth_cuda(s, s, s, s, tp.cth, tp.ln_sth, tp.logc)
    with pytest.raises(NotImplementedError, match="slice 11"):
        T.legendre_synthesis(tp, torch.zeros((tp.nl, tp.nm),
                                             dtype=torch.complex64), False)
