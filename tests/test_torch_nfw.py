"""NFW halo analytic test through the port (tests/test_nfw.py's
test_nfw_halo_deflection: the reference's NFWHALOTEST,
make_lensplanes_pointmass_test.c:247-367), on the CPU in float64: the
deflection magnitude at transverse radii inside r200 within a median 15 %
of the projected-NFW deflection, the JAX test's own bound.

The trace runs in a child process that loads only the port and the JAX
package's host-side plane maker (no JAX computation), with a timeout and
one retry: one of the suite's runs saw this test's worker process, which
had run JAX tests before, block on a lock (no CPU used) for minutes; the
same trace alone takes ~10 s."""
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from calclens_tpu.config import RayTraceConfig
from calclens_tpu.testing import pointmass as pm
from calclens_tpu_torch.driver import Raytracer, plane_params

conc = 5.0
cfg = RayTraceConfig(
    OmegaM=0.3, maxComvDistance=800.0, NumLensPlanes=8,
    LensPlanePath=sys.argv[2], LensPlaneName="nfwplane",
    SHTOrder=7, rayOrder=6, bundleOrder=3,
    partMass=2.0e17, raPointMass=32.0, decPointMass=14.0,
    radPointMass=150.0, NFWHaloTest=True, Precision="f64",
    SmoothingBeamFWHM=0.01,
).finalize()
vec, mass_plane, r200 = pm.make_nfw_planes(cfg, n_parts=100000, conc=conc)
rt = Raytracer(cfg, device="cpu")
rt.init_rays()
for p in range(mass_plane + 1):
    rt.step(p)
rays = rt.rays
alpha = np.asarray(rays.alpha)
n = np.asarray(rays.n)
nhat = n / np.linalg.norm(n, axis=1, keepdims=True)
gamma = np.arccos(np.clip(nhat @ vec, -1, 1))
pp = plane_params(cfg, rt.cosmo, mass_plane)
amag = np.hypot(alpha[:, 0], alpha[:, 1])
# transverse radii well inside r200 (the sampled halo is truncated there)
# but above the map resolution
gmin = 2.0 * cfg.SmoothingBeamFWHM
gmax = 0.6 * r200 / pp.rad
sel = (gamma > gmin) & (gamma < gmax)
ref = pm.alpha_nfw(gamma[sel], cfg, rt.cosmo, pp.rad, r200, conc,
                   cfg.partMass)
rel = np.abs(amag[sel] - ref) / ref
print(json.dumps({"selected": int(sel.sum()),
                  "median_rel": float(np.median(rel))}))
"""


def test_nfw_halo_deflection_through_port(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    last = None
    for attempt in range(2):  # one retry
        planes = tmp_path / f"planes{attempt}"
        planes.mkdir()
        try:
            res = subprocess.run([sys.executable, "-c", _CHILD, repo,
                                  str(planes)], env=env, capture_output=True,
                                 text=True, timeout=150)
        except subprocess.TimeoutExpired as e:
            last = f"timed out: {e}"
            continue
        assert res.returncode == 0, res.stdout + res.stderr
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["selected"] > 20
        assert out["median_rel"] < 0.15, out
        return
    raise AssertionError(f"the NFW trace timed out twice: {last}")
