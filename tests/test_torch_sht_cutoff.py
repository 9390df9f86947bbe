"""The per-tile turning-point m cutoff of K2 and K3 (calclens_tpu_torch.sht):
the rule against the JAX package's m_cutoff, the twins with forced cutoffs
against the Pallas synthesis kernels they replace in interpret mode (K2's
MXU kernel, K3's bucket kernel), and cut syntheses against uncut ones where
the rule cuts.

K2 leaves its raw columns, K3 its buckets, 0 for every (m, ring) whose m
is at or beyond the cutoff of the ring's 128-ring tile
(legendre.SYNTH_TILE_J): m_cutoff at
granularity 1 on the tile's largest sin theta.  The JAX package's
unstreamed synthesis does not cut, but at the orders of the port's parity
tests against it (<= 7) the rule gives nm on every tile of 128 rings or
more (order 7: the first tile's largest sin theta is 0.745, mlim 406 >=
nm = 384), so those tests compare uncut syntheses;
test_rule_cuts_nothing_up_to_order_7 holds that.  K3's Pallas reference
runs in a child process with a timeout (fixture pallas_buckets)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from calclens_tpu.sht import pallas_legendre_mx as MX
from calclens_tpu.sht import transforms as JT
from calclens_tpu.sht.plan import SHTPlan as JPlan
from calclens_tpu_torch.sht import legendre as TL
from calclens_tpu_torch.sht import transforms as T
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



# K3's forced-cutoff case: order 4, the Pallas bucket kernel's tiles, and
# the K2 case's 8-ring tiles (tile 0 cut at m = 16, tile 1 fully skipped)
_VPU_TILES = dict(TM=8, TJ=128, LB=16, tile_j=8)

# The raw buckets of the Pallas kernel behind synthesis_pallas, in TPU
# interpret mode, for both forms: run in a child process (argv: repo root,
# input npz, output npz), as tests/test_torch_tools.py runs the P1 tool,
# so that a stall of the interpret mode cannot hold this test process
_VPU_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from calclens_tpu.sht import pallas_legendre as PL

with np.load(sys.argv[2]) as z:
    inp = dict(z)
key = tuple(int(x) for x in inp["key"])
geo = jnp.stack([PL._pad_to(jnp.asarray(inp[k]), key[2], 0)
                 for k in ("cth", "sth", "cot", "inv_sth")])
out = {}
with pltpu.force_tpu_interpret_mode():
    for derivs in (True, False):
        alm = inp[f"alm{int(derivs)}"]
        ar, ai = (PL._pad_to(PL._pad_to(jnp.asarray(x), key[0], 0), key[1], 1)
                  for x in (alm.real, alm.imag))
        raw = PL._synthesis_buckets(key, ar, ai, geo, int(inp["nl"]), derivs)
        out[f"raw{int(derivs)}"] = np.stack([np.asarray(b) for b in raw], 1)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def pallas_buckets(tmp_path_factory):
    """derivs -> (alm, the Pallas bucket kernel's raw buckets [nm, ncol, J])
    at order 4 on the port plan's rings, from one child process (timeout
    120 s, one retry)."""
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    nm, nl, J = tp.nm, tp.nl, tp.J
    TM, TJ, LB = (_VPU_TILES[k] for k in ("TM", "TJ", "LB"))
    key = (-(-nl // LB) * LB, -(-nm // TM) * TM, -(-J // TJ) * TJ, LB, TM,
           TJ)
    alm = {d: _random_alm(nl, nm, 90 + d) for d in (True, False)}
    tmp = tmp_path_factory.mktemp("vpu")
    inp, outp = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, key=np.array(key), nl=nl, alm1=alm[True], alm0=alm[False],
             **{k: getattr(tp, k).numpy()
                for k in ("cth", "sth", "cot", "inv_sth")})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    last = None
    for _ in range(2):  # one retry
        try:
            res = subprocess.run([sys.executable, "-c", _VPU_CHILD, repo, inp,
                                  outp], env=env, capture_output=True,
                                 text=True, timeout=120)
        except subprocess.TimeoutExpired as e:
            last = f"timed out: {e}"
            continue
        if res.returncode == 0:
            with np.load(outp) as z:
                return {d: (alm[d], z[f"raw{int(d)}"][:nm, :, :J])
                        for d in (True, False)}
        last = res.stdout + res.stderr
    pytest.fail(f"the Pallas bucket kernel failed twice: {last}")


@pytest.mark.parametrize("derivs", [True, False])
def test_synth_vpu_twin_with_forced_cutoffs_matches_pallas_bucket_kernel(
        pallas_buckets, derivs):
    """K3's twin with the hand-forced cutoff of the K2 test above (8-ring
    tiles: tile 0 cut at m = 16, tile 1 fully skipped) against the raw
    buckets of the Pallas bucket kernel behind synthesis_pallas, in TPU
    interpret mode (order 4, TM=8, TJ=128, LB=16), zeroed on the same
    (m, ring) entries: the cut entries exactly 0, and the (qN, qS) that
    both give through synthesis_pallas's post-processing
    (legendre.q_from_buckets) within 1e-5 of each quantity's max, the bound
    of test_k3_twin_matches_pallas_bucket_kernel."""
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    nm, nl, J = tp.nm, tp.nl, tp.J
    alm, raw = pallas_buckets[derivs]
    tile_j = _VPU_TILES["tile_j"]
    mcut = np.full(J // tile_j, nm, np.int32)
    mcut[0], mcut[1] = 16, 0
    keep = np.arange(nm)[:, None] < np.repeat(mcut, tile_j)[None, :]
    ref = raw * keep[:, None, :]
    a_re, a_im = TL.mx_prep(nl, nm, torch.tensor(alm), torch.float32,
                            derivs=False)
    got = TL.synth_vpu_plain(a_re, a_im, tp.cth, tp.sth, tp.cot, tp.inv_sth,
                             derivs, mcut=torch.tensor(mcut),
                             tile_j=tile_j).numpy()
    assert got.shape == ref.shape == (nm, 12 if derivs else 4, J)
    assert not np.any(got * ~keep[:, None, :])
    qN, qS = TL.q_from_buckets(tp, torch.tensor(got))
    rN, rS = TL.q_from_buckets(tp, torch.tensor(ref))
    for k in range(qN.shape[0]):
        assert _relerr(qN[k].numpy(), rN[k].numpy()) < 1e-5, k
        assert _relerr(qS[k].numpy(), rS[k].numpy()) < 1e-5, k


@pytest.mark.parametrize("derivs", [True, False])
def test_cut_vpu_synthesis_matches_uncut_where_the_rule_cuts(derivs):
    """At NSIDE 256, the (qN, qS) of K3's twin with the plan's cutoff
    against the twin without it, on rows CUT_ROWS: 1e-6 of each quantity's
    max, the cut share being below float32 significance (lambda'' carries
    m^2 / sin^2 theta, and the cut entries stay below it too).  White
    alm."""
    tp = SHTPlan(8, "cpu", dtype=torch.float32)
    alm = torch.tensor(_random_alm(tp.nl, tp.nm, 81))
    rows = torch.tensor(CUT_ROWS)
    a_re, a_im = (x[rows] for x in TL.mx_prep(tp.nl, tp.nm, alm,
                                              torch.float32, derivs=False))
    geo = (tp.cth, tp.sth, tp.cot, tp.inv_sth, derivs)
    mcut = tp.mcut(TL.SYNTH_TILE_J)
    cut_b = TL.synth_vpu_plain(a_re, a_im, *geo, m=rows, mcut=mcut)
    full_b = TL.synth_vpu_plain(a_re, a_im, *geo, m=rows)
    jcut = mcut.repeat_interleave(TL.SYNTH_TILE_J)[: tp.J]
    assert bool((cut_b[rows >= 428][..., jcut <= 428] == 0).all())
    cut = TL.q_from_buckets(tp, cut_b, m=rows)
    full = TL.q_from_buckets(tp, full_b, m=rows)
    for h in (0, 1):
        for k in range(len(full[h])):
            assert _relerr(cut[h][k], full[h][k]) < 1e-6, (h, k)


def test_synth_vpu_twin_without_cutoff_is_unchanged():
    """synth_vpu_plain(mcut=None) cuts nothing: bit for bit the twin with a
    cutoff of nm on every tile, and the uncut values where a cutoff keeps
    them (the twin computes every entry, then zeroes the cut ones); the
    dispatcher passes the plan's cutoff, which cuts nothing at order 4."""
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    alm = torch.tensor(_random_alm(tp.nl, tp.nm, 82))
    a_re, a_im = TL.mx_prep(tp.nl, tp.nm, alm, torch.float32, derivs=False)
    geo = (tp.cth, tp.sth, tp.cot, tp.inv_sth, True)
    none = TL.synth_vpu_plain(a_re, a_im, *geo)
    full = torch.full((-(-tp.J // 8),), tp.nm, dtype=torch.int32)
    assert torch.equal(none, TL.synth_vpu_plain(a_re, a_im, *geo, mcut=full,
                                                tile_j=8))
    some = full.clone()
    some[1] = 20
    cut = TL.synth_vpu_plain(a_re, a_im, *geo, mcut=some, tile_j=8)
    keep = torch.arange(tp.nm)[:, None] < some.repeat_interleave(8)[None]
    assert torch.equal(cut, torch.where(keep[:, None], none, 0.0))
    tp.synth_kernel = "k3"
    qN, qS = T.legendre_synthesis(tp, alm, True)
    rN, rS = TL.q_from_buckets(tp, none)
    assert torch.equal(qN, rN) and torch.equal(qS, rS)
