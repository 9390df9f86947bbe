"""A tiny copy of the benchmark for the CPU tests: the repository's
benchmark/ and BENCHMARK.json in a temporary root, plus one cell of its
own ("tiny": the patch's box at SHTOrder 4 and rayOrder 6, 8192
particles) added as files."""

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

LIMIT_CELL = "sht4096-patch220-r14"  # the tiny cell takes this cell's limits
CONFIG = "patch220_sht_nside4096"     # and this configuration, cut down


def make_root(tmp, sht_order=4, ray_order=6, particles=8192):
    """A root holding a copy of the benchmark and a tiny cell; returns it:
    "tiny", the patch's configuration and box at SHTOrder sht_order and
    rayOrder ray_order, its particles in the dense mix's clumps."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        man = json.load(fp)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "traffic", "dense.json")) as fp:
        mix = json.load(fp)
    mix.update(particles=particles, clumps=16, staged_planes=2)
    _dump(os.path.join(b, "traffic", "tiny.json"), mix)
    with open(os.path.join(b, "cells", LIMIT_CELL + ".json")) as fp:
        cell = json.load(fp)
    cell["check"]["rays"] = 256
    cell["trace"] = {"profiler_planes": 2, "profile_planes": 2}
    _dump(os.path.join(b, "cells", "tiny.json"), cell)
    with open(os.path.join(b, "configs", CONFIG + ".json")) as fp:
        conf = json.load(fp)
    conf["raytrace"].update(SHTOrder=sht_order, rayOrder=ray_order,
                            bundleOrder=2)
    _dump(os.path.join(b, "configs", "tiny.json"), conf)
    man["configs"].append({
        "name": "tiny", "source": "a test", "reduced": [],
        "file": "benchmark/configs/tiny.json", "why": "tests"})
    man["workloads"].append({
        "name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1,
        "why": "tests"})
    for m in man["per_layer"]:
        m["workloads"].append("tiny")
    _dump(os.path.join(root, "BENCHMARK.json"), man)
    return root


def _dump(path, obj):
    with open(path, "w") as fp:
        json.dump(obj, fp, indent=1)


def run_tiny(root, trace=0, seed=2**31 + 7, seconds=0.5):
    import time

    from benchmark.harness import run

    return run(root, "tiny", seed, seconds, trace, "cpu", time.time(),
               log=lambda s: None)
