"""The port's ray side (calclens_tpu_torch/rays/soa.py interp_and_prop) must
reproduce the JAX package's straightforward array-of-struct implementation
(ops/interp.py + rays/propagate.py) in float64."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from calclens_tpu.healpix import core as hp
from calclens_tpu.healpix import jaxhp
from calclens_tpu.ops.interp import FieldMaps, shear_interp, apply_lensing_fields
from calclens_tpu.rays import propagate as rp
from calclens_tpu.rays import soa
from calclens_tpu_torch.healpix import torchhp
from calclens_tpu_torch.rays import soa as tsoa


def _random_rays(n, rng, wpm1):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    rays = rp.init_rays(jnp.asarray(v), wpm1, dtype=jnp.float64)
    beta = v + 0.01 * rng.normal(size=(n, 3))
    beta /= np.linalg.norm(beta, axis=1, keepdims=True)
    return rays._replace(
        beta=jnp.asarray(beta),
        A=jnp.asarray(np.eye(2) + 0.05 * rng.normal(size=(n, 2, 2))),
        Aprev=jnp.asarray(np.eye(2) + 0.05 * rng.normal(size=(n, 2, 2))),
        alpha=jnp.asarray(1e-3 * rng.normal(size=(n, 2))),
        U=jnp.asarray(1e-3 * rng.normal(size=(n, 2, 2))),
        phi=jnp.asarray(rng.normal(size=n)),
    )


@pytest.mark.parametrize("born", [False, True])
@pytest.mark.parametrize("chunk", [300, 1 << 22])
def test_port_interp_and_prop_matches_aos(born, chunk):
    """The port's interp_and_prop (on the CPU: the plain twin in column
    chunks, one chunk size smaller than N) against the AoS path."""
    order = 4
    rng = np.random.default_rng(3)
    tab = jaxhp.InterpTables(order, dtype=jnp.float64)
    npix = int(hp.order2npix(order))
    maps = FieldMaps(*[jnp.asarray(rng.normal(size=npix)) for _ in range(6)])
    wp, wpm1, wpm2 = 750.0, 500.0, 250.0

    rays = _random_rays(1024, rng, wpm1)
    z = rp.zero_plane_fields(rays)
    pot, grad, U = shear_interp(tab, maps, z.n)
    z = apply_lensing_fields(z, pot, grad, U)
    want = rp.rayprop_sphere(z, wp, wpm1, wpm2, born=born)

    packed = torch.tensor(np.asarray(soa.pack(rays)))
    maps7 = tsoa.with_pixel_ids(torch.tensor(np.stack(
        [np.asarray(m) for m in maps])))
    got = tsoa.interp_and_prop(
        torchhp.InterpTables(order), maps7, packed,
        *(torch.tensor(x, dtype=torch.float64) for x in (wp, wpm1, wpm2)),
        born, chunk=chunk)
    got = soa.unpack(jnp.asarray(got.numpy()))

    # another package's float64 arithmetic: 1e-12 of each field's range
    for name, a, b in zip(want._fields, want, got):
        a = np.asarray(a)
        np.testing.assert_allclose(np.asarray(b), a, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(a)),
                                   err_msg=name)
