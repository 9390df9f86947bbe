"""CLI entry point:

    python -m calclens_tpu_torch.raytrace <config> [restart_plane] [--device DEV]

The reference's main.c: read the config, then run the multiple-plane trace,
resuming from OutputPath/restart.npz when it exists (restart_plane overrides
the plane to resume at).  DEV is a torch device, cuda by default.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from calclens_tpu.config import read_config

from .driver import Raytracer


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calclens_tpu_torch.raytrace")
    ap.add_argument("config")
    ap.add_argument("restart_plane", nargs="?", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    cfg = read_config(args.config)
    rt = Raytracer(cfg, device=args.device)
    rpath = rt.restart_path()
    if os.path.exists(rpath):
        rt.load_restart(rpath)
        if args.restart_plane is not None:
            rt.current_plane = args.restart_plane
        print(f"resuming at plane {rt.current_plane} from {rpath}",
              file=sys.stderr)
    else:
        rt.init_rays()
    rt.run(start_time=t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
