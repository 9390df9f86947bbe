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
from calclens_tpu_torch.sht.legendre import ANALYSIS_TILE_J, analysis_mcut
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


@pytest.mark.parametrize("order", [3, 5])
def test_element_counts_match_brute_force(order):
    """production's element counts: every (l, m, j) that the kernels'
    loops reach, counted one by one."""
    plan = SHTPlan(order, "cpu", dtype=torch.float32)
    nl, nm, J = plan.nl, plan.nm, plan.J
    l = np.arange(nl)[:, None, None]
    m = np.arange(nm)[None, :, None]
    j = np.arange(J)[None, None, :]
    tri = l >= m
    mcut = analysis_mcut(plan.sth_host, nl, nm)
    below = m < mcut[j // ANALYSIS_TILE_J]
    synth = int(np.broadcast_to(tri, (nl, nm, J)).sum())
    ana = int((tri & below).sum())
    got = R.element_counts(plan)
    assert got["legendre_analysis"] == got["legendre_analysis_dot"] == ana
    for k in ("legendre_synth", "legendre_synth_phi", "legendre_synth_vpu"):
        assert got[k] == synth
    sl = slice(J - J // 8, J)
    part = R.element_counts(plan, sl)
    assert part["legendre_synth"] == int(
        np.broadcast_to(tri, (nl, nm, J))[:, :, sl].sum())
    assert part["legendre_analysis"] == int((tri & below)[:, :, sl].sum())
