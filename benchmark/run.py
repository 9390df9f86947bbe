"""The benchmark of calclens_tpu_torch on an NVIDIA GPU: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell (BENCHMARK.json's `workloads`)
is found by name, with its configuration, traffic mix, cell file and
metric readers (benchmark/harness.py).  --trace 0 times whole lens planes
of calclens_tpu_torch.driver.Raytracer.step for --seconds and prints the
cell's end-to-end metrics; --trace 1 traces a few planes (torch.profiler,
then the Raytracer's Profile mode) and prints its per-layer metrics.  Both
then check the last plane against the plain reference (reference.py) and
print each number compared beside its limit, on standard error and under
"check" in the last line of standard output, a JSON object.

It exits with another code than 0, and prints no result, when torch sees
no CUDA device or fewer than the cell asks for, and when a module of jax,
jaxlib, flax or the JAX package calclens_tpu is loaded.  The kernels build
once per checkout into build/kernels/; the traced run's trace goes to
bench_out/<workload>/.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from benchmark.harness import Cell, forbidden_modules, run

    cell = Cell(root, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s), torch sees "
              f"{n}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda", T_START, log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules {bad} are loaded after the window; "
              "no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in out["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
