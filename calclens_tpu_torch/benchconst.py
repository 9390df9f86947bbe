"""The measured reference step times that bench.py compares against, copied
for the port's bench (bench_torch.py), held to bench.py's own values by
tests/test_torch_copies.py.

Measured single-core reference step times (s/plane), 12.6M rays (rayOrder
10), 2M particles, gcc -O3 -march=native (tools/refbaseline; BASELINE.md).
Two anchor points: order 10 (NSIDE 1024, 233.8 s) and order 11 (NSIDE 2048,
2179.5 s).  The measured order-to-order ratio is 9.32x, above the pure-lmax^3
8x, so extrapolating the SHT share as lmax^3 from the nearest measured order
is conservative for vs_baseline.  vs_baseline assumes the reference README's
recommended 128-core allocation with perfect scaling.
"""

REF_MEASURED_STEP_S = {10: 233.8, 11: 2179.5}  # order -> s/plane (1 core)
REF_CLUSTER_CORES = 128  # README.md:118-120 recommended allocation


def reference_step_seconds(sht_order: int) -> float:
    if sht_order in REF_MEASURED_STEP_S:
        return REF_MEASURED_STEP_S[sht_order]
    base = max(REF_MEASURED_STEP_S)
    t = REF_MEASURED_STEP_S[base]
    # non-SHT remainder at order 11: PartIO 1.69 + RayProp 2.36 + init 2.37
    sht_share = 0.997 * t if base >= 11 else 0.94 * t
    other = t - sht_share
    return sht_share * 8.0 ** (sht_order - base) + other


def reference_core_step_seconds(sht_order: int, ray_order: int) -> float:
    """The reference's step time on one core at these shapes (bench.py):
    the step scales with the SHT (lmax^3) and, above the measured rayOrder
    10, with the rays only through RayProp (2.8 s of 234 s)."""
    return reference_step_seconds(sht_order) * (
        1.0 if ray_order <= 10 else
        1.0 + 0.012 * (4.0 ** (ray_order - 10) - 1.0))
