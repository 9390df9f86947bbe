"""The readings a cell's limits are set from, at the cell's own size, in
one process (one set-up for all seeds).

    python3 benchmark/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--planes 3]

For each seed: the rays from init_rays, the seed's staged planes and ray
sample, the warm-up plane and --planes more, then the check's per-ray
errors of the last plane (harness.per_ray_errors); for each control seed
also those of each control (harness.CONTROLS), the reference computed in
bfloat16, or in float32 with TF32 products, in the program's place; for each fault seed the same run again with each planted
fault (faults.py) in the program's timed path.  One JSON line per
reading: the cell's numbers (those its limits name) and more quantiles
over the sampled rays of each error.  The benchmark's own runs do not run
this.  It needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

QUANTILES = (0.5, 0.9, 0.95, 0.99, 1.0)  # 1.0: the largest


def readings(root, workload, seeds, control_seeds, planes, device, log=print,
             fault_seeds=()):
    import contextlib

    import torch

    from benchmark import harness
    from benchmark.faults import FAULTS, planted

    dev = torch.device(device)
    cell = harness.Cell(root, workload)
    cfg = harness.make_config(cell)
    sp = None
    limits = cell.cell["check"]["limits"]
    out = []
    runs = [(seed, None) for seed in seeds]
    runs += [(seed, f) for f in FAULTS for seed in fault_seeds]
    for seed, fault in runs:
        t0 = time.perf_counter()
        with planted(fault) if fault else contextlib.nullcontext():
            if sp is None:
                box = harness.sky(cfg, cell.config)[0] is not None
                sp = harness.Stepper(cell, cfg, dev, seed, keep_start=box)
            else:
                sp.new_seed(seed)
            for _ in range(planes + 1):
                sp.step()
        rec = sp.record(keep_program=True)
        kinds = [("fault:" + fault if fault else "program", None)]
        if seed in control_seeds and not fault:
            kinds += [("control:" + c, c) for c in harness.CONTROLS]
        for kind, control in kinds:
            t1 = time.perf_counter()
            per = harness.per_ray_errors(cfg, rec, control)
            line = {"kind": kind, "seed": seed, "plane": rec["plane"],
                    "rays": len(rec["init_cols"]),
                    "seconds": time.perf_counter() - t0,
                    "reference_s": time.perf_counter() - t1}
            line["numbers"] = harness.numbers(per, limits)
            for k, v in per.items():
                v = v.double().cpu()
                line[k] = {str(q): float(torch.quantile(v, q)) for q in QUANTILES}
            log(json.dumps(line))
            out.append(line)
        del rec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--planes", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("control: torch sees no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    faulty = [int(s) for s in args.fault_seeds.split(",") if s]
    readings(root, args.workload, seeds, ctrl, args.planes, "cuda",
             log=lambda s: print(s, flush=True), fault_seeds=faulty)
    return 0


if __name__ == "__main__":
    sys.exit(main())
