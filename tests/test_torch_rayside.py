"""The ray side's kernel (csrc/rayside.cu through soa.interp_and_prop_cuda)
against its plain twin (soa.chunked_into over interp_and_prop_chunk), and
the dispatch of soa.interp_and_prop.

The kernel computes what the twin computes on the card, operation by
operation, so the two are compared bit for bit, on: full-sky rays off the
pixel centres with rays within 1e-3 rad of each pole (the north and south
folds) and rays at the phi = 0 / 2 pi wrap; box rays; a window of the maps
from pix_base > 0 whose taps are clamped; born and full propagation; maps
with no gradient, so alpha = 0 (the unbent branch).  The card tests are
marked `cuda` and skip without a GPU; run them on the card with

    python -m pytest tests/test_torch_rayside.py -m cuda --noconftest

The CPU tests hold interp_and_prop to the chunked twin.  No JAX here.
"""

import numpy as np
import pytest
import torch

from calclens_tpu_torch import _ext
from calclens_tpu_torch.config import RayTraceConfig
from calclens_tpu_torch.driver import Raytracer
from calclens_tpu_torch.healpix import core as hp
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.rays import soa
from calclens_tpu_torch.utils import profile as P

MAP_ORDER = 5
RAY_ORDER = 6
RADII = (750.0, 625.0, 375.0)  # wp, wpm1, wpm2
CHUNK = 1 << 22  # the twin's column chunk where the test sets none
# lensing-sized fields: phi ~1e-4, deflections ~1e-3 rad, shear ~1e-2
SCALE = np.array([1e-4, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2])[:, None]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _unit(theta, phi):
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)])


def _fullsky_dirs(rng):
    """[3, n]: every RING pixel centre of RAY_ORDER moved off the centre,
    then rays within 1e-3 rad of each pole and rays at the phi wrap."""
    npix = 12 * 4**RAY_ORDER
    v = hp.pix2vec_ring(np.arange(npix), RAY_ORDER).T
    v = v + 0.05 * rng.normal(size=v.shape) / (1 << RAY_ORDER)
    th_pole = 10.0 ** rng.uniform(-6, -3, size=64)
    ph_pole = rng.uniform(0, 2 * np.pi, size=64)
    th_wrap = rng.uniform(0.02, np.pi - 0.02, size=32)
    ph_wrap = np.repeat([0.0, 1e-9, -1e-9, -1e-12], 8)
    extra = [_unit(th_pole, ph_pole), _unit(np.pi - th_pole, ph_pole),
             _unit(th_wrap, ph_wrap)]
    v = np.concatenate([v] + extra, axis=1)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _box_dirs(rng, n=20000):
    """[3, n]: uniform in the cells' box, 10 <= ra <= 24.709,
    |dec| <= 7.5 degrees."""
    ra = np.radians(rng.uniform(10.0, 24.709, size=n))
    dec = np.radians(rng.uniform(-7.5, 7.5, size=n))
    return _unit(np.pi / 2 - dec, ra)


def _state(v, rng, dtype=np.float32):
    """Packed [21, n] at unit vectors v: beta, A and A_prev perturbed; the
    per-plane rows 14-20 random (the ray side must ignore them)."""
    n = v.shape[1]
    r = np.zeros((21, n))
    r[0:3] = v * RADII[1]
    b = v + 0.01 * rng.normal(size=v.shape)
    r[3:6] = b / np.linalg.norm(b, axis=0, keepdims=True)
    r[6:14] = (np.tile(np.array([1.0, 0, 0, 1.0])[:, None], (2, n))
               + 0.01 * rng.normal(size=(8, n)))
    r[14:21] = rng.normal(size=(7, n))
    return r.astype(dtype)


def _maps(rng, dtype=np.float32, zero_grad=False):
    m = rng.normal(size=(6, 12 * 4**MAP_ORDER)) * SCALE
    if zero_grad:
        m[1:3] = 0.0
    return m.astype(dtype)


def _case(name, seed, dtype=np.float32):
    """(packed, maps7, pix_base) as numpy-made tensors on the CPU."""
    rng = np.random.default_rng(seed)
    dirs = _box_dirs(rng) if name == "box" else _fullsky_dirs(rng)
    packed = torch.tensor(_state(dirs, rng, dtype))
    maps6 = torch.tensor(_maps(rng, dtype, zero_grad=name == "unbent"))
    base = 0
    if name == "window":  # a third of the maps: most rays' taps clamp
        npix = maps6.shape[1]
        base, end = npix // 3, 2 * npix // 3
        maps6 = maps6[:, base:end].contiguous()
    return packed, soa.with_pixel_ids(maps6, base=base), base


def _scalars(dtype, device):
    return [torch.tensor(x, dtype=dtype, device=device) for x in RADII]


def _twin(tab, maps7, packed, scal, born, base, chunk):
    return soa.chunked_into(
        lambda b: soa.interp_and_prop_chunk(tab, maps7, b, *scal, born,
                                            pix_base=base), packed, chunk)


def _assert_bits(got, ref):
    """Equal bits, or the rows and ulps by which they differ."""
    gi, ri = got.view(torch.int32), ref.view(torch.int32)
    bad = gi != ri
    if bool(bad.any()):
        ulps = (gi.to(torch.int64) - ri.to(torch.int64)).abs()
        rows = {int(k): (int(bad[k].sum()), int(ulps[k].max()))
                for k in range(got.shape[0]) if bool(bad[k].any())}
        raise AssertionError(f"kernel != twin: row -> (columns, max ulps) "
                             f"{rows}")


# ----------------------------------------------------------------------------
# the CPU: interp_and_prop is the chunked twin
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("born", [False, True])
@pytest.mark.parametrize("chunk", [1000, 1 << 22])
def test_interp_and_prop_on_the_cpu_is_the_chunked_twin(dtype, born, chunk):
    """On the CPU (float32 and float64) interp_and_prop takes the plain twin in
    column chunks of `chunk` (one smaller than N, one larger), with the
    mesh window's pix_base; packed is left as it was."""
    tab = torchhp.InterpTables(MAP_ORDER)
    scal = _scalars(torch.float32 if dtype == np.float32 else torch.float64,
                    "cpu")
    for name in ("fullsky", "window"):
        packed, maps7, base = _case(name, 5, dtype)
        held = packed.clone()
        got = soa.interp_and_prop(tab, maps7, packed, *scal, born,
                                  pix_base=base, chunk=chunk)
        ref = _twin(tab, maps7, packed, scal, born, base, chunk)
        assert got.shape == packed.shape and got.dtype == packed.dtype
        assert torch.equal(got, ref), name
        assert torch.equal(packed, held), name


def test_the_kernel_wrapper_refuses_cpu_tensors():
    tab = torchhp.InterpTables(MAP_ORDER)
    packed, maps7, base = _case("box", 6)
    with pytest.raises(ValueError, match="not on CUDA"):
        soa.interp_and_prop_cuda(tab, maps7, packed,
                                 *_scalars(torch.float32, "cpu"), False)


# ----------------------------------------------------------------------------
# the card: the kernel against the twin
# ----------------------------------------------------------------------------

CARD_CASES = ["fullsky", "box", "window", "unbent"]


@pytest.mark.cuda
@pytest.mark.parametrize("born", [False, True])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_equals_twin_on_the_card(cuda_device, case, born):
    """Bit for bit against the twin run on the card; packed untouched;
    one launch per call; the same plane twice gives equal bits."""
    tab = torchhp.InterpTables(MAP_ORDER)
    packed, maps7, base = _case(case, 7 + CARD_CASES.index(case))
    packed, maps7 = packed.to(cuda_device), maps7.to(cuda_device)
    scal = _scalars(torch.float32, cuda_device)
    held = packed.clone()
    n0 = _ext.launches["rayside"]
    got = soa.interp_and_prop(tab, maps7, packed, *scal, born, chunk=CHUNK,
                              pix_base=base)
    assert _ext.launches["rayside"] == n0 + 1
    ref = _twin(tab, maps7, packed, scal, born, base, CHUNK)
    torch.cuda.synchronize()
    assert torch.equal(packed, held)
    _assert_bits(got, ref)
    if case == "unbent" and not born:
        assert bool((got[14:16] == 0).all())    # alpha = 0: not bent
        assert torch.equal(got[3:6], packed[3:6])
    again = soa.interp_and_prop(tab, maps7, packed, *scal, born,
                                chunk=CHUNK, pix_base=base)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_dispatch_and_checks_on_the_card(cuda_device):
    """Tensors on the card go to the kernel, which raises on float64 as
    every kernel of the port does, and on whatever else it does not take;
    nothing is launched then."""
    tab = torchhp.InterpTables(MAP_ORDER)
    packed, maps7, base = _case("fullsky", 11, np.float64)
    packed, maps7 = packed.to(cuda_device), maps7.to(cuda_device)
    scal = _scalars(torch.float64, cuda_device)
    n0 = _ext.launches["rayside"]
    with pytest.raises(TypeError, match="float32 only"):
        soa.interp_and_prop(tab, maps7, packed, *scal, False, chunk=CHUNK,
                            pix_base=base)
    assert _ext.launches["rayside"] == n0

    p32, m32 = packed.float(), maps7.float()
    s32 = _scalars(torch.float32, cuda_device)
    bad = {
        "float64 maps": (p32, maps7, s32, 0),
        "a Python radius": (p32, m32, [RADII[0]] + s32[1:], 0),
        "radii on the CPU": (p32, m32, _scalars(torch.float32, "cpu"), 0),
        "strided maps": (p32, m32[:, ::2], s32, 0),
        "6-row maps": (p32, m32[:6].contiguous(), s32, 0),
        "a window past the maps": (p32, m32, s32, 1),
    }
    for what, (p, m, s, b) in bad.items():
        with pytest.raises((TypeError, ValueError)):
            soa.interp_and_prop_cuda(tab, m, p, *s, False, pix_base=b)
        assert _ext.launches["rayside"] == n0, what


@pytest.mark.cuda
def test_one_launch_per_plane_of_the_sht_step(cuda_device):
    """Raytracer.step (SHT only, full sky) runs the ray side as one launch
    and one rayside_kernel count per plane; the plane stepped twice from
    one state gives equal bits."""
    cfg = RayTraceConfig(OmegaM=0.3, maxComvDistance=1500.0, NumLensPlanes=6,
                         SHTOrder=6, rayOrder=6, bundleOrder=2,
                         Precision="f32").finalize()
    rt = Raytracer(cfg, device=cuda_device)
    rt.init_rays()
    rng = np.random.default_rng(12)
    v = rng.normal(size=(20000, 3))
    pos = v / np.linalg.norm(v, axis=1, keepdims=True) * 400.0
    mass = rng.uniform(1e12, 5e13, size=len(pos))
    rt.step(1, pos, mass)
    torch.cuda.synchronize()
    P.take()
    start = rt.rays_packed.clone()
    n0 = _ext.launches["rayside"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rt.step(2, pos, mass)
    torch.cuda.synchronize()
    planes = [s for s in P.take() if s.name == "PLANE"]
    assert len(planes) == 1
    assert planes[0].counts.get("rayside_kernel") == 1
    assert _ext.launches["rayside"] == n0 + 1
    first = rt.rays_packed.clone()
    rt.rays_packed = start
    rt.step(2, pos, mass)
    assert torch.equal(first.view(torch.int32),
                       rt.rays_packed.view(torch.int32))
