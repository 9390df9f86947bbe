"""The port's measurement tools (calclens_tpu_torch/tools) on the CPU, where
their wrappers run the plain versions of the P1-P4 kernels.

P1 (roofline_legendre.probe) is held against the TPU tool's own `_probe`
(tools/roofline_legendre.py) in Pallas TPU interpret mode at MT=2, LBLK=2,
LB=8, TM=8, TJ=128.  The JAX side runs in a child process: importing the
TPU tool rewrites jax.config's compilation-cache settings for its process,
and TPU interpret mode has deadlocked in this suite before, so both stay
out of the test process (timeout 120 s, one retry).  The gathers P2-P4 are
closures inside the TPU tool's main() and cannot be called; their plain
versions are held against `jnp.asarray(tab)[idx]`, that tool's own
baseline C.  Tolerances are stated at each test."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from calclens_tpu_torch import tools
from calclens_tpu_torch.sht.legendre import (ANALYSIS_TILE_J, SYNTH_TILE_J,
                                             analysis_mcut, synth_mcut)
from calclens_tpu_torch.sht.plan import SHTPlan
from calclens_tpu_torch.tools import exp_gather as G
from calclens_tpu_torch.tools import roofline_legendre as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(MT=2, LBLK=2, LB=8, TM=8, TJ=128)
COMPARED = ("rec", "rec+store", "store")

_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import roofline_legendre as rl
from jax.experimental.pallas import tpu as pltpu

geo = rl.jnp.asarray(np.random.default_rng(0).uniform(
    -0.9, 0.9, (5, 128)).astype(np.float32))
out = {}
with pltpu.force_tpu_interpret_mode():
    for i, mode in enumerate(("rec", "rec+store", "store")):
        out[f"m{i}"] = np.asarray(rl._probe(2, 2, 8, 8, 128, mode, geo))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_probe(tmp_path_factory):
    """The TPU tool's _probe outputs for the compared modes, from a child
    process."""
    path = str(tmp_path_factory.mktemp("probe") / "jax_probe.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    last = None
    for _ in range(2):  # one retry
        try:
            res = subprocess.run(
                [sys.executable, "-c", _CHILD, os.path.join(REPO, "tools"),
                 path], env=env, capture_output=True, text=True,
                timeout=120)
        except subprocess.TimeoutExpired as e:
            last = f"timed out: {e}"
            continue
        if res.returncode == 0:
            with np.load(path) as z:
                return {m: z[f"m{i}"] for i, m in enumerate(COMPARED)}
        last = res.stdout + res.stderr
    pytest.fail(f"JAX reference probe failed twice: {last}")


@pytest.mark.parametrize("mode", COMPARED)
def test_probe_matches_jax_probe(jax_probe, mode):
    """Same float32 coefficients and recurrence.  The port rounds every
    operation as K1-K4 do; XLA's CPU backend contracts the recurrence's
    cth * pc - b * pp into a fused multiply-add, so the two differ in the
    last bits of about half the values, which the recurrence carries on
    (8.0e-9 of the max measured).  Bound: 1e-6 of max |value|; the values
    reach 1.7e16 at this shape and stay finite."""
    got = R.probe(geo=R.default_geo(SHAPE["TJ"]), mode=mode, **SHAPE)
    ref = jax_probe[mode]
    assert got.shape == ref.shape == (2, 8, 128)
    assert np.all(np.isfinite(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    if mode == "store":
        np.testing.assert_array_equal(got.numpy(), 0.5)


def test_probe_dot_matches_closed_form():
    """The TPU's dot mode contracts a scratch that nothing in that mode
    writes, so its value is undefined (NaN in interpret mode) and cannot be
    compared.  The port contracts S[k, i] = i float32(0.01 k + 1) against a
    tile of 0.5, so out[m, r, k, j] = LBLK 0.5 sum_i S[k, i]; float32 sums
    of < 100 terms: within 1e-6."""
    got = R.probe(geo=R.default_geo(SHAPE["TJ"]), mode="dot", **SHAPE)
    S = (np.arange(SHAPE["LB"], dtype=np.float32)[None, :]
         * np.array([np.float32(0.01 * k + 1.0) for k in range(16)])[:, None])
    want = SHAPE["LBLK"] * 0.5 * S.astype(np.float64).sum(axis=1)
    assert got.shape == (2, 8, 16, 128)
    np.testing.assert_allclose(got.numpy(),
                               np.broadcast_to(want[:, None], got.shape),
                               rtol=1e-6, atol=0)


def test_probe_refuses_what_the_kernel_cannot_take():
    geo = R.default_geo(128)
    with pytest.raises(ValueError, match="mode"):
        R.probe(2, 2, 8, 8, 128, "mxu", geo)
    with pytest.raises(ValueError, match="power of two"):
        R.probe(2, 2, 8, 8, 96, "rec", R.default_geo(96))
    with pytest.raises(ValueError, match="shared memory"):
        R.probe(2, 2, 8192, 8, 32, "rec", R.default_geo(32))
    with pytest.raises(ValueError, match="not on CUDA"):
        R.probe_cuda(2, 2, 8, 8, 128, "rec", geo)
    with pytest.raises(RuntimeError, match="CUDA device"):
        R.ceilings("cpu")


def _gather_inputs():
    tab, idx = G.inputs(n=1 << 14, seed=3)
    return tab, idx, np.asarray(jnp.asarray(tab.numpy())[idx.numpy()])


@pytest.mark.parametrize("name", ["gather_rows", "gather_lanes",
                                  "gather_onehot"])
def test_gather_plain_versions_match_jax_gather(name):
    """A gather copies values: equal bit for bit."""
    tab, idx, ref = _gather_inputs()
    if name == "gather_lanes":
        got = G.gather_lanes(tab.T.contiguous(), idx)
        np.testing.assert_array_equal(got.numpy(), ref.T)
    else:
        got = getattr(G, name)(tab, idx)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.float32


def test_bf16_parts_carry_float32_exactly():
    """hi + mid + lo is the float32 value exactly, in any summation order
    that the one-hot route uses, across the float32 exponent range."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(4096),
                        rng.standard_normal(4096) * 1e-30,
                        rng.standard_normal(4096) * 1e30,
                        [1.0, -1.0, 3.0e38, 1.17549435e-38]]
                       ).astype(np.float32)
    t = torch.tensor(x)
    hi, mid, lo = G.bf16_parts(t)
    np.testing.assert_array_equal(((hi.float() + mid.float()) + lo.float()
                                   ).numpy(), x)
    np.testing.assert_array_equal(
        hi.double().numpy() + mid.double().numpy() + lo.double().numpy(),
        x.astype(np.float64))


def test_gather_cuda_wrappers_refuse_cpu_tensors():
    tab, idx = G.inputs(n=64)
    for fn, t in ((G.gather_rows_cuda, tab), (G.gather_onehot_cuda, tab),
                  (G.gather_lanes_cuda, tab.T.contiguous())):
        with pytest.raises(ValueError, match="CUDA"):
            fn(t, idx)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tools.require_cuda("cpu")


@pytest.mark.parametrize("order", [3, 5, 8])
def test_element_counts_match_brute_force(order):
    """production's element counts: every (l, m, j) that the kernels'
    loops reach, counted one ring at a time: below the 512-ring tiles'
    cutoff for K1 and K4, below the 128-ring tiles' cutoff for K2 and K3 in
    both forms (which cuts at order 8 only)."""
    plan = SHTPlan(order, "cpu", dtype=torch.float32)
    nl, nm, J = plan.nl, plan.nm, plan.J
    tri = np.arange(nl)[:, None] >= np.arange(nm)[None, :]
    m = np.arange(nm)[None, :]
    j = np.arange(J)
    ana_cut = analysis_mcut(plan.sth_host, nl, nm)[j // ANALYSIS_TILE_J]
    syn_cut = synth_mcut(plan.sth_host, nl, nm)[j // SYNTH_TILE_J]
    ana = np.array([(tri & (m < c)).sum() for c in ana_cut])  # per ring
    syn = np.array([(tri & (m < c)).sum() for c in syn_cut])
    assert (syn.sum() < tri.sum() * J) == (order == 8)
    got = R.element_counts(plan)
    assert got["legendre_analysis"] == got["legendre_analysis_dot"] == ana.sum()
    assert got["legendre_synth"] == got["legendre_synth_phi"] == syn.sum()
    assert got["legendre_synth_vpu"] == got["legendre_synth_vpu_phi"] \
        == syn.sum()
    sl = slice(J - J // 8, J)
    part = R.element_counts(plan, sl)
    assert part["legendre_synth_vpu"] == syn[sl].sum()
    assert part["legendre_synth"] == syn[sl].sum()
    assert part["legendre_analysis"] == ana[sl].sum()


def test_steady_loop_sass_follows_the_steady_path():
    """steady_loop_sass on a made-up listing: the innermost loop with a
    vote and a predicated backward branch (not the divergent-vote fallback
    that jumps back unconditionally), walked from its head through each
    predicated branch's fall-through and each unconditional jump."""
    body = """
        Function : _Z24legendre_analysis_kernelPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R3, R4, R5 ;
        /*0020*/              @!P0 BRA 0x60 ;
        /*0030*/                   FFMA R6, R7, R8, R6 ;
        /*0040*/                   BRA 0x80 ;
        /*0050*/                   NOP ;
        /*0060*/                   FSETP.GT.AND P1, PT, |R3|, 4.29e9, PT ;
        /*0070*/                   VOTE.ALL P0, P0 ;
        /*0080*/                   IADD3 R9, R9, 0x10, RZ ;
        /*0090*/              @!P2 BRA 0x10 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   VOTE.ALL P0, P0 ;
        /*00c0*/                   BRA 0x60 ;
"""
    got = R.steady_loop_sass(body)
    assert list(got) == ["legendre_analysis"]
    r = got["legendre_analysis"]
    assert r["group"] == 6
    assert r["ops"] == {"FMUL": 1, "BRA": 3, "FFMA": 1, "IADD3": 1}
    _, rings, group = R.STEADY_KERNELS["legendre_analysis_kernel"]
    assert r["per_element"] == 6 / group / rings


def test_steady_loop_sass_counts_tensor_core_instructions_apart():
    """K4's steady loop holds its contraction's HMMA: per_element counts
    every instruction of the path, cuda_core_per_element all but HMMA."""
    body = """
        Function : _Z28legendre_analysis_dot_kernelPKf
        /*0000*/                   FMUL R3, R4, R5 ;
        /*0010*/                   STS.128 [R2], R4 ;
        /*0020*/                   LDS.128 R8, [R2] ;
        /*0030*/                   HMMA.1688.F32.TF32 R12, R8, R20, R12 ;
        /*0040*/                   HMMA.1688.F32.TF32 R16, R8, R22, R16 ;
        /*0050*/              @!P0 BRA 0x80 ;
        /*0060*/                   VOTE.ALL P0, P0 ;
        /*0070*/                   FSETP.GT.AND P1, PT, |R3|, 4.29e9, PT ;
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/              @!P2 BRA 0x0 ;
        /*00a0*/                   EXIT ;
"""
    r = R.steady_loop_sass(body)["legendre_analysis_dot"]
    _, rings, group = R.STEADY_KERNELS["legendre_analysis_dot_kernel"]
    assert r["ops"] == {"FMUL": 1, "STS": 1, "LDS": 1, "HMMA": 2, "BRA": 2,
                        "BAR": 1}
    assert r["per_element"] == 8 / group / rings
    assert r["cuda_core_per_element"] == 6 / group / rings


def test_legendre_variants_edit_the_sources_once():
    """Every edit of tools/legendre_variants.py names text that occurs
    exactly once in its source, so each variant differs from the built
    kernels by just its edits; the tool needs a CUDA device."""
    from calclens_tpu_torch import _ext
    from calclens_tpu_torch.tools import legendre_variants as V

    assert V.VARIANTS["as built"] == []
    for name, edits in V.VARIANTS.items():
        for src, text, new in edits:
            with open(os.path.join(_ext.SRC_DIR, src)) as fp:
                assert fp.read().count(text) == 1, (name, src, text)
            assert new != text
    with pytest.raises(RuntimeError, match="CUDA device"):
        V.run(4, "cpu")
