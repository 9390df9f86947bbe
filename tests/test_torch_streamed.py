"""The port's j-block streamed synthesis (calclens_tpu_torch.sht.transforms.
_alm2allmaps_streamed and its parts) against the JAX package's
(calclens_tpu.sht.transforms._alm2allmaps_streamed, alm2allmaps_host_streamed,
_synth_ring_rows, _synth_stream_blocks, m_cutoff), the table policy of the
plan, and the ray side's preallocated output.

The JAX side runs its scan path (plan.use_pallas = False), as
tests/test_streamed_synthesis.py does.  Torch is pinned to one thread.
Tolerances, relative to each map's max |value|: float64 1e-12 against JAX
(the same sums in other orders), float32 1e-6 streamed against unstreamed
(the same kernels' twins on the same columns), 1e-10 for the driver trace
(two FFT libraries through three planes)."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calclens_tpu import driver as jdriver
from calclens_tpu.config import RayTraceConfig as JConfig
from calclens_tpu.healpix import core as hp
from calclens_tpu.sht import transforms as JT
from calclens_tpu_torch import driver as tdriver
from calclens_tpu_torch import poisson as tpoisson
from calclens_tpu_torch.config import RayTraceConfig
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.rays import soa as tsoa
from calclens_tpu_torch.sht import legendre as TL
from calclens_tpu_torch.sht import transforms as T
from calclens_tpu_torch.sht.plan import SHTPlan, pix2ring_index

torch.set_num_threads(1)

_JREF = {}
# the driver trace's configuration (the plan of every JAX reference)
TRACE = dict(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
             SHTOrder=5, rayOrder=4, bundleOrder=2, Precision="f64")


def _jrt():
    """The JAX Raytracer of the driver trace (Profile on: its phase-split
    step), made once for the module, on the scan path; its order-5 float64
    plan serves every JAX reference, so the trace's host-streamed synthesis
    finds the blocks that the "host" reference compiled (a JAX plan keys
    its compiled functions by identity)."""
    if "rt" not in _JREF:
        jrt = _JREF["rt"] = jdriver.Raytracer(
            JConfig(Profile=True, **TRACE).finalize())
        jrt.plan.use_pallas = False
    return _JREF["rt"]


def _alm(nl, nm, seed, cdt=np.complex128):
    rng = np.random.default_rng(seed)
    l = np.arange(nl)[:, None]
    m = np.arange(nm)[None, :]
    alm = np.where(m <= l, rng.normal(size=(nl, nm))
                   + 1j * rng.normal(size=(nl, nm)), 0.0)
    alm[:, 0] = alm[:, 0].real
    return alm.astype(cdt)


def _map_errs(got, ref):
    """Max over the maps of max |got - ref| / max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    return max(float(np.abs(got[i] - ref[i]).max() / np.abs(ref[i]).max())
               for i in range(len(ref)))


# the j-blocks of each JAX reference: the host-streamed one at the driver
# trace's count, so the trace's JAX synthesis finds its blocks compiled
JAX_BLOCKS = {"ingraph": 2, "host": 4}


def _jax_streamed(kind):
    """JAX's maps of the order-5 alm (seed 5), made once per kind for the
    module: "ingraph", _alm2allmaps_streamed under jit (as JAX's jitted
    plane step runs it), "host", alm2allmaps_host_streamed (as its
    phase-split step runs it), each at JAX_BLOCKS[kind] j-blocks.  Each JAX
    count compiles its blocks anew (~3 s per block here), so the JAX side
    runs one count per kind and the port's counts are held to it (at order
    5 no window cuts a column, so every count sums the same terms)."""
    if kind not in _JREF:
        jp = _jrt().plan
        alm = jnp.asarray(_alm(jp.nl, jp.nm, 5))
        nblk = JAX_BLOCKS[kind]
        jp.synth_stream = nblk
        if kind == "ingraph":
            maps = jax.jit(lambda a: jnp.stack(
                JT._alm2allmaps_streamed(jp, a, nblk)))(alm)
        else:
            maps = JT.alm2allmaps_host_streamed(jp, alm, nblk)
        jp.synth_stream = None
        _JREF[kind] = np.asarray(maps)
    return _JREF[kind]


@pytest.mark.parametrize("kernel", ["k2", "k3"])
@pytest.mark.parametrize("nblk", [2, 4, 8])
@pytest.mark.parametrize("kind", ["ingraph", "host"])
def test_streamed_alm2allmaps_matches_jax(kind, nblk, kernel):
    """Order 5, float64: the port's streamed alm2allmaps (with K2's or K3's
    twin) at 2, 4 and 8 j-blocks against JAX's _alm2allmaps_streamed
    ("ingraph") and alm2allmaps_host_streamed ("host") on the same alm,
    1e-12 of each map's max."""
    ref = _jax_streamed(kind)
    tp = SHTPlan(5, "cpu", dtype=torch.float64)
    tp.synth_kernel = kernel
    tp.synth_stream = nblk
    assert T.synth_stream_blocks(tp) == nblk
    got = T.alm2allmaps(tp, torch.tensor(_alm(tp.nl, tp.nm, 5))).numpy()
    assert _map_errs(got, ref) < 1e-12


@pytest.mark.parametrize("nblk", [4, 32])
def test_float32_streamed_matches_unstreamed(nblk):
    """Order 6, float32: streamed against the port's own unstreamed
    synthesis on one alm (1e-6 of each map's max); the output buffer is
    written in place, each pixel once."""
    tp = SHTPlan(6, "cpu", dtype=torch.float32)
    alm = torch.tensor(_alm(tp.nl, tp.nm, 60, np.complex64))
    ref = T.alm2allmaps(tp, alm)
    tp.synth_stream = nblk
    out = torch.full((6, tp.npix), float("nan"))
    got = T.alm2allmaps(tp, alm, out=out)
    assert got is out and bool(torch.isfinite(out).all())
    assert _map_errs(got.numpy(), ref.numpy()) < 1e-6


@pytest.mark.parametrize("r0,r1", [(3, 20), (40, 70), (20, 50)],
                         ids=["cap", "belt", "cap-belt"])
def test_ring_rows_match_jax(r0, r1):
    """The row-range ring synthesis against JAX's _synth_ring_rows at
    order 5 (caps rings 0-30 and 96-126), float64, 1e-12 of max: a cap
    range, a belt range and ranges straddling the cap/belt boundary."""
    jp = _jrt().plan
    tp = SHTPlan(5, "cpu", dtype=torch.float64)
    rng = np.random.default_rng(r0)
    S = (rng.normal(size=(3, r1 - r0, tp.nm))
         + 1j * rng.normal(size=(3, r1 - r0, tp.nm)))
    # under jit, as JAX's blocks run it (eager, each op compiles alone)
    ref = np.asarray(jax.jit(functools.partial(JT._synth_ring_rows, jp),
                             static_argnums=(1, 2))(jnp.asarray(S), r0, r1))
    got = T.synth_ring_rows(tp, torch.tensor(S), r0, r1).numpy()
    assert got.shape == ref.shape == (3, tp.startpix[r1] - tp.startpix[r0])
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
    assert len(T.ring_subranges(tp, r0, r1)) == (1 if r0 in (3, 40) else 2)
    assert len(T.ring_subranges(tp, 20, 110)) == 3


def test_stream_block_overrides_match_jax(monkeypatch):
    """synth_stream_blocks' overrides against _synth_stream_blocks on stub
    plans: the plan attribute, CALCLENS_SYNTH_STREAM (read when the port's
    plan is built, at the call by JAX) and 1 below order 10."""
    def stub(order, nblk=None):
        return types.SimpleNamespace(order=order, synth_stream=nblk,
                                     spec=None)

    monkeypatch.delenv("CALCLENS_SYNTH_STREAM", raising=False)
    for order in (4, 9):
        assert T.synth_stream_blocks(stub(order)) == 1 == \
            JT._synth_stream_blocks(stub(order))
        assert T.synth_stream_blocks(SHTPlan(order, "cpu")) == 1
    for order, nblk in ((4, 8), (11, 2), (13, 16)):
        assert T.synth_stream_blocks(stub(order, nblk)) == nblk == \
            JT._synth_stream_blocks(stub(order, nblk))
    monkeypatch.setenv("CALCLENS_SYNTH_STREAM", "4")
    tp = SHTPlan(5, "cpu")
    assert tp.synth_stream == 4
    assert T.synth_stream_blocks(tp) == 4 == JT._synth_stream_blocks(stub(5))
    monkeypatch.delenv("CALCLENS_SYNTH_STREAM")
    assert T.synth_stream_blocks(tp) == 4  # read at the plan's build
    tp.synth_stream = None
    assert T.synth_stream_blocks(tp) == 1


def test_default_block_counts_divide_J():
    """Every per-order default divides J, for the orders it names and the
    orders above that take the last one."""
    for order in range(10, 14):
        nblk = T.synth_stream_blocks(types.SimpleNamespace(order=order))
        assert nblk >= 1 and (2 << order) % nblk == 0, (order, nblk)
    assert T.synth_stream_blocks(types.SimpleNamespace(order=13)) > 1


@pytest.mark.parametrize("order", [12, 13])
def test_window_cutoffs_from_host_geometry(order):
    """The window's per-tile cutoffs at orders 12 and 13 (one plan, no
    tables built): each tile's cutoff is m_cutoff at granularity 1 on the
    tile's largest sin theta of the host ring table, and never above JAX's
    window cutoff (m_cutoff at granularity 512 on the window's rings)."""
    tp = SHTPlan(order, "cpu")
    assert tp.tables.builds == 0
    sth = np.sin(hp.build_ring_table(order).theta[: tp.J])
    nblk = T.SYNTH_STREAM_BLOCKS[13] if order == 13 else 32
    jb = tp.J // nblk
    tile = TL.SYNTH_TILE_J
    for j0 in range(0, tp.J, jb):
        win = tp.window(j0, j0 + jb)
        cut = win.mcut(tile).numpy()
        ref = [JT.m_cutoff(tp.nl - 1, float(sth[t: min(t + tile, j0 + jb)]
                                            .max()), tp.nm, granularity=1)
               for t in range(j0, j0 + jb, tile)]
        np.testing.assert_array_equal(cut, ref)
        jax_cut = JT.m_cutoff(tp.nl - 1, float(sth[j0: j0 + jb].max()), tp.nm)
        assert cut.max() <= jax_cut
        assert win.cth.is_contiguous() and win.J == jb
    assert tp.tables.builds == 0


def test_pix2ring_index_in_chunks():
    """pix2ring_index built in chunks of pixels equals the one-pass index
    (the whole map in one chunk), for the map's rings and for a cap
    range's rows."""
    tp = SHTPlan(5, "cpu")
    sp = tp.startpix[: tp.nrings]
    base = np.arange(tp.nrings) * tp.P
    one = pix2ring_index(sp, base, tp.npix, "cpu", chunk=tp.npix)
    for chunk in (1000, 4096, 7):
        assert torch.equal(pix2ring_index(sp, base, tp.npix, "cpu",
                                          chunk=chunk), one)
    seg = tp.startpix[20:31] - tp.startpix[20]  # rings of 84-124 pixels
    a = pix2ring_index(seg, np.arange(11) * 124,
                       int(tp.startpix[31] - tp.startpix[20]), "cpu")
    b = pix2ring_index(seg, np.arange(11) * 124, int(a.numel()), "cpu",
                       chunk=13)
    assert torch.equal(a, b) and int(a.max()) == 11 * 124 - 1


def test_table_policy_gives_the_same_transforms():
    """A plan that keeps no table (max_bytes 0: the phase tables applied in
    blocks of rows, every other table built per call) gives the analysis
    and both synthesis ring stages of a plan that keeps them all, and
    keeps nothing."""
    full = SHTPlan(5, "cpu", dtype=torch.float64)
    bare = SHTPlan(5, "cpu", dtype=torch.float64)
    bare.tables.max_bytes = 0
    alm = torch.tensor(_alm(full.nl, full.nm, 9))
    maps = T.alm2allmaps(full, alm)
    for mode, v2 in (("v2", True), ("uniform", False)):
        for p in (full, bare):
            p.synthesis_rings_mode, p.use_rings_v2 = mode, v2
        assert torch.allclose(T.alm2allmaps(bare, alm), T.alm2allmaps(
            full, alm), rtol=0, atol=1e-14 * float(maps.abs().max()))
        a, b = T.map2alm(full, maps[0]), T.map2alm(bare, maps[0])
        assert float((a - b).abs().max()) <= 1e-14 * float(a.abs().max())
    assert bare.tables.nbytes() == 0 and full.tables.nbytes() > 0


@pytest.mark.parametrize("empty", [False, True])
def test_rayside_into_preallocated_buffer_bit_equal(monkeypatch, empty):
    """phase_rayside (and the empty plane's propagation) write each chunk
    into one preallocated buffer: bit-equal to the concatenation of the
    chunk outputs (soa.chunked before this change) with RAYSIDE_CHUNK patched
    small, the [7, npix] maps' id row made once; the input is left as it
    was."""
    order = 4
    npix = 12 * 4**order
    rng = np.random.default_rng(11)
    packed = tsoa.init_packed_fullsky(order, 300.0, npix, "cpu",
                                      torch.float32)
    packed[14:21] = torch.tensor(rng.normal(size=(7, npix)),
                                 dtype=torch.float32)
    held = packed.clone()
    maps6 = torch.tensor(1e-3 * rng.normal(size=(6, npix)),
                         dtype=torch.float32)
    maps7 = tsoa.with_pixel_ids(maps6)
    scal = tpoisson.PlaneScalars(*(torch.tensor(x) for x in
                                   (0.0, 0.0, 400.0, 300.0, 200.0)))
    tab = torchhp.InterpTables(order)
    chunk = 1000  # not a divisor of npix: the last chunk is short
    monkeypatch.setattr(tpoisson, "RAYSIDE_CHUNK", chunk)
    if empty:
        got = tpoisson.empty_plane_step_packed(False, packed, scal)

        def fn(b):
            return tsoa.prop_only_chunk(b, scal.wp, scal.wpm1, scal.wpm2,
                                        False)
    else:
        got = tpoisson.phase_rayside(tab, packed, maps7, scal, False)

        def fn(b):
            return tsoa.interp_and_prop_chunk(tab, maps7, b, scal.wp,
                                              scal.wpm1, scal.wpm2, False)
    zeroed = tsoa.zero_plane_rows(packed)
    ref = torch.cat([fn(zeroed[:, i: i + chunk])
                     for i in range(0, npix, chunk)], dim=1)
    assert torch.equal(got, ref)
    assert torch.equal(packed, held)


def test_phase_synthesis_returns_the_id_row():
    """phase_synthesis gives [7, npix]: rows 0-5 alm2allmaps' maps, row 6
    the ray side's pixel-id row."""
    tp = SHTPlan(4, "cpu", dtype=torch.float32)
    alm = torch.tensor(_alm(tp.nl, tp.nm, 3, np.complex64))
    out = tpoisson.phase_synthesis(tp, alm)
    assert out.shape == (7, tp.npix)
    assert torch.equal(out[:6], T.alm2allmaps(tp, alm))
    assert torch.equal(out, tsoa.with_pixel_ids(out[:6]))


def _plane_particles(p, seed=17, n=2000):
    rng = np.random.default_rng(seed + p)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rad = (p + rng.uniform(0.0, 1.0, size=(n, 1))) * 250.0
    return v * rad, rng.uniform(1e12, 5e13, size=n)


def test_streamed_driver_trace_matches_jax():
    """Three planes (an empty one among them) at SHTOrder 5 / rayOrder 4,
    float64, synth_stream 4 (JAX_BLOCKS["host"]) on both drivers: JAX's
    phase-split step with Profile takes its host-streamed synthesis
    (phase_synthesis_host), the port its streamed alm2allmaps; from one
    packed state, compared after every plane at 1e-10 of each quantity's
    max."""
    jrt = _jrt()
    jrt.plan.synth_stream = JAX_BLOCKS["host"]
    trt = tdriver.Raytracer(RayTraceConfig(**TRACE).finalize(), device="cpu")
    trt.plan.synth_stream = JAX_BLOCKS["host"]
    trt.init_rays()
    start = trt.rays_packed.numpy().copy()
    jrt.rays_packed = jnp.asarray(start)
    jrt.current_plane = 1
    trt.load_state(start, 1, 0)
    groups = ((0, 3), (3, 6), (6, 10), (10, 14), (14, 16), (16, 20),
              (20, 21))
    for p in (1, 2, 3):
        pos, mass = _plane_particles(p) if p != 2 else ([], [])
        jrt.step(p, pos=pos, mass=mass)
        trt.step(p, pos=pos, mass=mass)
        ref = np.asarray(jrt.rays_packed)
        got = trt.rays_packed.numpy()
        for a, b in groups:
            scale = np.abs(ref[a:b]).max() + 1e-300
            assert np.abs(got[a:b] - ref[a:b]).max() < 1e-10 * scale, (p, a)
    assert np.abs(ref[14:16]).max() > 0  # deflected
