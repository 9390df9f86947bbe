"""Nothing a run imports is JAX or the JAX package, and the reference
loads nothing of the program."""

import os
import subprocess
import sys

from bench_tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "calclens_tpu"}


def _modules(code):
    res = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    return set(res.stdout.split())


def test_a_run_loads_no_jax():
    mods = _modules(
        "import benchmark.run, benchmark.harness, benchmark.control, "
        "benchmark.reference, benchmark.traffic, benchmark.tracing, "
        "benchmark.roofline\n"
        "import calclens_tpu_torch.driver, calclens_tpu_torch._ext")
    assert "calclens_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import benchmark.reference")
    assert "calclens_tpu_torch" not in mods
    assert not mods & FORBIDDEN
