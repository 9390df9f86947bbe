"""The harness on the CPU at a tiny size: cells, configurations, traffic
and metrics found by name; a cell, a mix and a metric added as files; the
result line's keys; no card, no result."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from bench_tiny import REPO, make_root, run_tiny

from benchmark import harness

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fp:
        return json.load(fp)


def test_every_name_has_its_files():
    man = manifest()
    b = os.path.join(REPO, "benchmark")
    for c in man["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    for w in man["workloads"]:
        cell = harness.Cell(REPO, w["name"])
        assert cell.config["raytrace"]["SHTOrder"] > 0
        assert cell.traffic["particles"] > 0
        for name in cell.cell["check"]["limits"]:
            err, stat = name.rsplit("_", 1)
            assert err in harness.ERRORS
            assert stat == "max" or 0 < float(stat[1:]) <= 100
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.isfile(os.path.join(b, "metrics", m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in man["workloads"]}


def test_metrics_of_a_cell():
    cell = harness.Cell(REPO, "sht4096-patch220-r14")
    assert [m["name"] for m in cell.metrics(False)] == [
        "plane_s", "peak_gib", "setup_s"]
    assert "sht_s" in [m["name"] for m in cell.metrics(True)]


def _hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fp:
                out[os.path.relpath(p, root)] = hashlib.sha1(fp.read()).hexdigest()
    return out


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    """A new cell, traffic mix and per-layer metric take new files and
    new BENCHMARK.json entries only: no file of the benchmark is edited."""
    root = make_root(tmp_path)
    b = os.path.join(root, "benchmark")
    before = _hashes(b)
    with open(os.path.join(b, "traffic", "tiny.json")) as fp:
        mix = json.load(fp)
    mix.update(particles=4096, clump_share=0.0)
    with open(os.path.join(b, "traffic", "tiny_uniform.json"), "w") as fp:
        json.dump(mix, fp)
    with open(os.path.join(b, "cells", "tiny.json")) as fp:
        cellf = json.load(fp)
    with open(os.path.join(b, "cells", "tiny-uniform.json"), "w") as fp:
        json.dump(cellf, fp)
    with open(os.path.join(b, "metrics", "planes_traced.py"), "w") as fp:
        fp.write("def read(run):\n    return float(run.planes)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        man = json.load(fp)
    man["workloads"].append({"name": "tiny-uniform", "config": "tiny",
                             "traffic": "tiny_uniform", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "planes_traced", "unit": "planes",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "plane_s",
                             "workloads": ["tiny-uniform"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(man, fp)
    after = _hashes(b)
    assert all(after[k] == v for k, v in before.items())
    import time

    out = harness.run(root, "tiny-uniform", 5, 0.2, 1, "cpu", time.time(),
                      log=lambda s: None)
    assert out["metrics"]["planes_traced"]["value"] == 4.0
    assert out["correct"]


def test_result_line_keys(tmp_path):
    root = make_root(tmp_path)
    out = run_tiny(root)
    assert set(out) == RESULT_KEYS | {"check"}
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"plane_s", "setup_s"}  # no peak off the card
    assert out["correct"]
    for c in out["check"].values():
        assert set(c) == {"value", "limit"}
    traced = run_tiny(root, trace=1)
    assert set(traced) == RESULT_KEYS | {"check", "breakdown"}
    assert list(traced)[-1] == "check"
    assert {"sht_s", "rayprop_s", "deposit_s", "shtsolve_s"} <= set(
        traced["metrics"])
    # the CPU trace has no device events: no device metric is reported
    assert "device_idle_pct" not in traced["metrics"]
    assert "legendre_synth_roofline_pct" not in traced["metrics"]


def test_no_card_no_result():
    """run.py with no CUDA device exits nonzero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "run.py"),
         "--workload", "sht4096-patch220-r14", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "CUDA" in res.stderr


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, the
    program is missing: nonzero exit, no result."""
    import shutil

    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(tmp_path, "benchmark"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         "sht4096-patch220-r14", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    root = make_root(tmp_path)
    out = harness.run(root, "tiny", 9, 0.5, 1, "cuda", time.time(),
                      log=lambda s: None)
    assert out["correct"]
    assert out["device"]["busy_s"] > 0


def test_the_kernel_build_is_not_in_setup_s(tmp_path, monkeypatch):
    """A run whose process built the kernels reports setup_s without the
    build's seconds."""
    import time

    from calclens_tpu_torch import _ext

    root = make_root(tmp_path)
    monkeypatch.setattr(_ext, "build_seconds", 1000.0)
    out = harness.run(root, "tiny", 4, 0.2, 0, "cpu", time.time() - 1000.0,
                      log=lambda s: None)
    assert 0 < out["metrics"]["setup_s"]["value"] < 1000.0
