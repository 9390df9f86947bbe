"""K2's per-tile turning-point m cutoff (calclens_tpu_torch.sht): the rule
against the JAX package's m_cutoff, K2's twin with forced cutoffs against
the Pallas MXU synthesis kernel in interpret mode, and a cut synthesis
against the uncut one where the rule cuts.

K2 leaves its raw columns 0 for every (m, ring) whose m is at or beyond
the cutoff of the ring's 128-ring tile (legendre.SYNTH_TILE_J): m_cutoff at
granularity 1 on the tile's largest sin theta.  The JAX package's
unstreamed synthesis does not cut, but at the orders of the port's parity
tests against it (<= 7) the rule gives nm on every tile of 128 rings or
more (order 7: the first tile's largest sin theta is 0.745, mlim 406 >=
nm = 384), so those tests compare uncut syntheses;
test_rule_cuts_nothing_up_to_order_7 holds that."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from calclens_tpu.sht import pallas_legendre_mx as MX
from calclens_tpu.sht import transforms as JT
from calclens_tpu.sht.plan import SHTPlan as JPlan
from calclens_tpu_torch.sht import legendre as TL
from calclens_tpu_torch.sht.plan import SHTPlan


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _random_alm(nl, nm, seed):
    rng = np.random.default_rng(seed)
    l = np.arange(nl)[:, None]
    m = np.arange(nm)[None, :]
    alm = np.where(m <= l, rng.normal(size=(nl, nm))
                   + 1j * rng.normal(size=(nl, nm)), 0.0)
    alm[:, 0] = alm[:, 0].real
    return alm.astype(np.complex64)


@pytest.mark.parametrize("derivs", [True, False])
def test_synth_twin_with_forced_cutoffs_matches_pallas_mx_kernel(derivs):
    """K2's twin with a hand-forced cutoff on 8-ring tiles (tile 0 cut at
    m = 16, tile 1 fully skipped, tiles 2 and 3 full) against the Pallas MXU
    kernel in TPU interpret mode (order 4, TM=8, TJ=128, LB=16 as
    tests/test_pallas_mx.py), whose raw columns are zeroed on the same
    (m, ring) entries: 1e-5 of each column's max; the cut entries exactly
    0."""
    jp = JPlan(4, dtype=jnp.float32)
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    nm, nl, J = tp.nm, tp.nl, tp.J
    alm = _random_alm(nl, nm, 70 + derivs)
    TM, TJ, LB, tile_j = 8, 128, 16, 8
    ncol = 16 if derivs else 4
    key = (-(-nl // LB) * LB, -(-nm // TM) * TM, -(-J // TJ) * TJ, LB, TM,
           TJ, 8, MX._MX_CORFAC_SKIP, MX._MX_BATCHED_DOT)
    prepped = MX.mx_prep(nl, nm, jnp.asarray(alm), derivs, TM=TM, LB=LB)
    with pltpu.force_tpu_interpret_mode():
        raw = MX._synth_mx_raw(key, *prepped, MX._geo_rows(jp, key[2]), ncol)
    mcut = np.full(J // tile_j, nm, np.int32)
    mcut[0], mcut[1] = 16, 0
    keep = np.arange(nm)[:, None] < np.repeat(mcut, tile_j)[None, :]
    ref = np.asarray(raw)[:nm, :, :J] * keep[:, None, :]
    streams = TL.mx_prep(nl, nm, torch.tensor(alm), torch.float32, derivs)
    cols = TL.synth_plain(streams, tp.cth, tp.ln_sth, tp.logc,
                          torch.tensor(mcut), tile_j=tile_j).numpy()
    assert cols.shape == (nm, ncol, J)
    assert not np.any(cols * ~keep[:, None, :])
    for c in range(ncol):
        assert _relerr(cols[:, c], ref[:, c]) < 1e-5, c


def test_synth_cutoff_rule_matches_m_cutoff():
    """synth_mcut is m_cutoff at granularity 1 on each 128-ring tile's
    largest sin theta; the plan builds each tile width's cutoff once and
    K1's is analysis_mcut's."""
    sth = np.sin(np.linspace(1e-3, np.pi / 2, 2048))
    nl = nm = 6144
    got = TL.synth_mcut(sth, nl, nm)
    T_ = TL.SYNTH_TILE_J
    ref = [JT.m_cutoff(nl - 1, float(np.max(sth[t * T_:(t + 1) * T_])), nm,
                       granularity=1) for t in range(len(sth) // T_)]
    np.testing.assert_array_equal(got, ref)
    assert got[0] < got[3] < nm  # polar tiles are cut, more near the pole
    tp = SHTPlan(8, "cpu", dtype=torch.float32)
    k2 = tp.mcut(TL.SYNTH_TILE_J)
    assert k2 is tp.mcut(TL.SYNTH_TILE_J) and k2.dtype == torch.int32
    np.testing.assert_array_equal(
        k2.numpy(), TL.synth_mcut(tp.sth_host, tp.nl, tp.nm))
    np.testing.assert_array_equal(
        tp.mcut(TL.ANALYSIS_TILE_J).numpy(),
        TL.analysis_mcut(tp.sth_host, tp.nl, tp.nm))
    # NSIDE 256: the first 128-ring tile cuts at m ~ 430 of 768
    assert 400 < int(k2[0]) < 450 and int(k2[-1]) == tp.nm


@pytest.mark.parametrize("order", [2, 3, 4, 5, 6, 7])
def test_rule_cuts_nothing_up_to_order_7(order):
    tp = SHTPlan(order, "cpu", dtype=torch.float32)
    assert bool((tp.mcut(TL.SYNTH_TILE_J) == tp.nm).all())


# rows around the first tile's cutoff at order 8 (m ~ 427), and the ends
CUT_ROWS = (0, 1, 2, 200, 400, 426, 427, 428, 500, 766, 767)


@pytest.mark.parametrize("derivs", [True, False])
def test_cut_synthesis_matches_uncut_where_the_rule_cuts(derivs):
    """At NSIDE 256, where the rule cuts the polar tiles, the (qN, qS) of
    K2's twin with the plan's cutoff against the twin without it, on rows
    CUT_ROWS (the twins compute those rows only): 1e-6 of each quantity's
    max, the cut share being below float32 significance.  Inputs: white
    alm (every m as loud as m = 0)."""
    tp = SHTPlan(8, "cpu", dtype=torch.float32)
    alm = torch.tensor(_random_alm(tp.nl, tp.nm, 80))
    rows = torch.tensor(CUT_ROWS)
    sub = tuple(x[rows] for x in TL.mx_prep(tp.nl, tp.nm, alm, torch.float32,
                                           derivs))
    geo = (tp.cth, tp.ln_sth, tp.logc[rows])
    mcut = tp.mcut(TL.SYNTH_TILE_J)
    cut_cols = TL.synth_plain(sub, *geo, mcut, m=rows)
    jcut = mcut.repeat_interleave(TL.SYNTH_TILE_J)[: tp.J]
    assert bool((cut_cols[rows >= 428][..., jcut <= 428] == 0).all())
    cut = TL.q_from_columns(tp, cut_cols, m=rows)
    full = TL.q_from_columns(tp, TL.synth_plain(sub, *geo, m=rows), m=rows)
    for h in (0, 1):
        for k in range(len(full[h])):
            assert _relerr(cut[h][k], full[h][k]) < 1e-6, (h, k)

