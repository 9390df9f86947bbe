"""CLI entry point:

    python -m calclens_tpu_torch.raytrace <config> [restart_plane] [--device DEV]

The reference's main.c: read the config, then resume from OutputPath's
sharded checkpoint restart_sharded/ (what run() writes), or else from its
restart.npz, or else from a reference run's binary restart.0 files there
(restart_plane overrides the plane to resume at), or start new rays; then
run the multiple-plane trace, or the CMB propagation mode when CMBLensing is
set (main.c:95-101).  A restart_sharded.tmp/ left by an interrupted write
is never resumed from.  DEV is a torch device, cuda by default.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .config import read_config
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
    spath = rt.sharded_restart_path()
    rpath = rt.restart_path()
    legacy = os.path.join(cfg.OutputPath or ".", "restart.0")
    resumed = None
    if os.path.isdir(spath):
        rt.load_restart_sharded(spath)
        resumed = spath
    elif os.path.exists(rpath):
        rt.load_restart(rpath)
        resumed = rpath
    elif os.path.exists(legacy):
        # a REFERENCE run's binary restart files (restart.c layout)
        rt.load_legacy_restart(cfg.OutputPath or ".")
        resumed = f"legacy {legacy}"
    else:
        rt.init_rays()
    if resumed is not None:
        if args.restart_plane is not None:
            rt.current_plane = args.restart_plane
        print(f"resuming at plane {rt.current_plane} from {resumed}",
              file=sys.stderr)

    if cfg.CMBLensing:
        run_cmb_mode(rt)
    else:
        rt.run(start_time=t0)
    return 0


def run_cmb_mode(rt):
    """CMB-lensing mode with the reference's output set
    (propagate_to_cmb_from_restart.c:184-492): propagate the rays to
    chi(z = 1100), then write

      * restart_rays_at_cmb.0: the updated rays in the reference restart
        byte layout (when WriteRaysAtCMB; the reference's
        write_restart_files_for_rays_at_cmb, :203, 389-438);
      * CMB_convergence_<nside>.fits: per-pixel mean kappa, 0 where no ray
        lands, and CMB_rays_<nside>.fits: the 7-column lens-map sums (when
        WriteCMBMaps, :440-492).

    The map order (CMBMapOrder, or 12 when it is -1) must not exceed
    rayOrder: that raises ValueError before any work.  Returns the paths
    written."""
    from . import maps as lm
    from .io import legacy_restart as lr

    cfg = rt.cfg
    map_order = cfg.CMBMapOrder if cfg.CMBMapOrder >= 0 else lm.CMB_MAP_ORDER
    lm.check_map_order(cfg.rayOrder, map_order)
    outdir = cfg.OutputPath or "."
    os.makedirs(outdir, exist_ok=True)
    nside = 1 << map_order

    accum = rt.propagate_to_cmb(map_order=map_order)

    written = []
    if cfg.WriteRaysAtCMB:
        written.append(lr.write_legacy_restart(
            outdir, cfg, rt.rays_packed.cpu().numpy(), rt.ray_nest,
            current_plane=rt.current_plane, filename="restart_rays_at_cmb.0"))
    if cfg.WriteCMBMaps:
        cpath = os.path.join(outdir, f"CMB_convergence_{nside}.fits")
        lm.write_single_map_fits(lm.convergence_from_accum(accum), nside,
                                 cpath)
        rpath = os.path.join(outdir, f"CMB_rays_{nside}.fits")
        lm.write_lens_map_fits(accum, nside, rpath)
        written += [cpath, rpath]
    for p in written:
        print(f"wrote {p}", file=sys.stderr)
    return written


if __name__ == "__main__":
    sys.exit(main())
