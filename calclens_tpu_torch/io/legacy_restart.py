"""Reader/writer for the reference's binary restart files (restart.c:18-219).

The reference's marquee decoupled mode — propagate_to_cmb_from_restart —
consumes an existing run's per-task `restart.<task>` binaries
(propagate_to_cmb_from_restart.c:224-265).  This module parses that exact
byte layout so calclens_tpu can post-process reference runs (and export its
own state for the reference to consume).

The port's own copy of calclens_tpu/io/legacy_restart.py (host numpy;
tests/test_torch_cmb.py holds it to the original, byte for byte).

Per-task file layout (restart.c:66-171, x86-64 default-flag build; all
struct sizes verified against the compiled reference headers):

    int32   NTasks
    int32   fspd (USE_FULLSKY_PARTDIST flag)
    RayTraceData                      [13656 bytes]
    int64   NbundleCells
    HEALPixBundleCell[NbundleCells]   [64 bytes each]
    int64[NbundleCells]  nest -> restricted-peano hash
    int64[NbundleCells]  restricted-peano -> nest hash
    int64   NrestrictedPeanoInd
    int64[NTasks] firstRestrictedPeanoIndTasks
    int64[NTasks] lastRestrictedPeanoIndTasks
    int32   PRIMARY_BUNDLECELL flag value (0)
    HEALPixRay[NraysPerBundleCell] for each PRIMARY bundle cell, in
        bundle-cell (nest) order   [176 bytes each: int64 nest + 21 f64]
"""

from __future__ import annotations

import os
import struct

import numpy as np

RTD_SIZE = 13656          # sizeof(RayTraceData), default flags, x86-64
BC_SIZE = 64              # sizeof(HEALPixBundleCell)
RAY_DTYPE = np.dtype([
    ("nest", "<i8"),
    ("n", "<f8", (3,)), ("beta", "<f8", (3,)), ("alpha", "<f8", (2,)),
    ("A", "<f8", (4,)), ("Aprev", "<f8", (4,)), ("U", "<f8", (4,)),
    ("phi", "<f8"),
])
assert RAY_DTYPE.itemsize == 176

BC_DTYPE = np.dtype([
    ("nest", "<i8"), ("active", "<u4"), ("_pad", "<u4"),
    ("Nparts", "<i8"), ("firstPart", "<i8"), ("Nrays", "<i8"),
    ("rays_ptr", "<u8"), ("firstMapCell", "<i8"), ("cpuTime", "<f8"),
])
assert BC_DTYPE.itemsize == BC_SIZE

# (offset, struct code) for the RayTraceData fields we consume; offsets
# verified with offsetof() against the reference's raytrace.h
_RTD_FIELDS = {
    "OmegaM": (16, "<d"),
    "maxComvDistance": (24, "<d"),
    "NumLensPlanes": (32, "<q"),
    "NumRayOutputFiles": (7216, "<q"),
    "bundleOrder": (7232, "<q"),
    "rayOrder": (7240, "<q"),
    "minRa": (7248, "<d"),
    "maxRa": (7256, "<d"),
    "minDec": (7264, "<d"),
    "maxDec": (7272, "<d"),
    "SHTOrder": (9336, "<q"),
    "Restart": (13504, "<q"),
    "CurrentPlaneNum": (13512, "<q"),
    "CurrentMapNum": (13520, "<q"),
}

PRIMARY_BUNDLECELL = 0


def _parse_rtd(raw):
    out = {}
    for name, (off, code) in _RTD_FIELDS.items():
        out[name] = struct.unpack_from(code, raw, off)[0]
    return out


def read_legacy_restart_file(path):
    """One restart.<task> file -> (meta dict, bundle cells, rays structured
    array over this task's PRIMARY cells, primary cell nest indices)."""
    with open(path, "rb") as fp:
        ntasks, fspd = struct.unpack("<ii", fp.read(8))
        rtd = _parse_rtd(fp.read(RTD_SIZE))
        (nbc,) = struct.unpack("<q", fp.read(8))
        bc = np.frombuffer(fp.read(nbc * BC_SIZE), dtype=BC_DTYPE)
        nest2rpi = np.frombuffer(fp.read(8 * nbc), dtype="<i8")
        rpi2nest = np.frombuffer(fp.read(8 * nbc), dtype="<i8")
        (nrpi,) = struct.unpack("<q", fp.read(8))
        first = np.frombuffer(fp.read(8 * ntasks), dtype="<i8")
        last = np.frombuffer(fp.read(8 * ntasks), dtype="<i8")
        (pbc,) = struct.unpack("<i", fp.read(4))
        if pbc != PRIMARY_BUNDLECELL:
            raise ValueError(f"unexpected PRIMARY_BUNDLECELL flag {pbc}")
        nrays_cell = 1 << (2 * (rtd["rayOrder"] - rtd["bundleOrder"]))
        primary = (bc["active"] & (1 << PRIMARY_BUNDLECELL)) != 0
        ncells = int(primary.sum())
        rays = np.frombuffer(fp.read(ncells * nrays_cell * RAY_DTYPE.itemsize),
                             dtype=RAY_DTYPE)
        if len(rays) != ncells * nrays_cell:
            raise ValueError(f"truncated restart file {path}")
    meta = dict(rtd, NTasks=ntasks, fspd=fspd, NbundleCells=nbc,
                NrestrictedPeanoInd=nrpi,
                firstRPI=first, lastRPI=last,
                nest2rpi=nest2rpi, rpi2nest=rpi2nest)
    return meta, bc, rays, bc["nest"][primary]


def read_legacy_restart(output_path):
    """All restart.<t> files of a reference run -> (meta, rays structured
    array over every primary cell, globally in bundle-nest order)."""
    meta0, _, _, _ = read_legacy_restart_file(
        os.path.join(output_path, "restart.0"))
    all_rays = []
    all_cells = []
    for t in range(meta0["NTasks"]):
        _, _, rays, cells = read_legacy_restart_file(
            os.path.join(output_path, f"restart.{t}"))
        all_rays.append(rays)
        all_cells.append(cells)
    rays = np.concatenate(all_rays)
    cells = np.concatenate(all_cells)
    order = np.argsort(cells, kind="stable")
    nrays_cell = 1 << (2 * (meta0["rayOrder"] - meta0["bundleOrder"]))
    rays = rays.reshape(-1, nrays_cell)[order].reshape(-1)
    return meta0, rays


def legacy_rays_to_packed(meta, rays, dtype=np.float32):
    """Structured legacy rays -> (packed f32[21, N] SoA buffer in NEST
    order, ray nest indices).  Row layout matches rays/soa.py ROWS."""
    order = np.argsort(rays["nest"], kind="stable")
    r = rays[order]
    n = len(r)
    packed = np.empty((21, n), dtype)
    packed[0:3] = r["n"].T
    packed[3:6] = r["beta"].T
    packed[6:10] = r["A"].T
    packed[10:14] = r["Aprev"].T
    packed[14:16] = r["alpha"].T
    packed[16:20] = r["U"].T
    packed[20] = r["phi"]
    return packed, r["nest"].copy()


def write_legacy_restart(output_path, cfg, rays_packed, ray_nest,
                         current_plane, map_num=0, ntasks=1,
                         filename="restart.0"):
    """Export calclens_tpu ray state as a reference-format restart.0 (single
    task) so the reference binary can consume it (the exporter direction of
    the interop; restart.c write path).  `filename` overrides the default
    for the CMB-mode rays-at-CMB export (restart_rays_at_cmb.N, same byte
    layout, propagate_to_cmb_from_restart.c:389-438)."""
    from ..healpix import core as hp

    nest = np.asarray(ray_nest, np.int64)
    packed = np.asarray(rays_packed, np.float64)
    k2 = 2 * (cfg.rayOrder - cfg.bundleOrder)
    nbc = int(hp.order2npix(cfg.bundleOrder))
    cell = nest >> k2
    # rays sorted by (bundle cell nest, ray nest)
    order = np.lexsort((nest, cell))
    nest = nest[order]
    packed = packed[:, order]
    cells_present = np.unique(cell)
    active = np.zeros(nbc, np.uint32)
    active[cells_present] |= 1 << PRIMARY_BUNDLECELL
    # FULLSKY_PARTDIST_PRIMARY (bit 4): normally set by init_bundlecells
    # (raytrace_utils.c:562) which the reference SKIPS on restart — the
    # fullsky particle read selects cells by this flag (partio.c:519); a
    # single-task export owns the whole sky
    active |= 1 << 4

    rtd = bytearray(RTD_SIZE)
    vals = dict(OmegaM=cfg.OmegaM, maxComvDistance=cfg.maxComvDistance,
                NumLensPlanes=cfg.NumLensPlanes,
                NumRayOutputFiles=getattr(cfg, "NumRayOutputFiles", 1),
                bundleOrder=cfg.bundleOrder, rayOrder=cfg.rayOrder,
                minRa=cfg.minRa, maxRa=cfg.maxRa, minDec=cfg.minDec,
                maxDec=cfg.maxDec, SHTOrder=cfg.SHTOrder,
                Restart=0, CurrentPlaneNum=current_plane,
                CurrentMapNum=map_num)
    for name, (off, code) in _RTD_FIELDS.items():
        struct.pack_into(code, rtd, off, vals[name])

    bc = np.zeros(nbc, BC_DTYPE)
    bc["nest"] = np.arange(nbc)
    bc["active"] = active
    nrays_cell = 1 << k2
    bc["Nrays"][cells_present] = nrays_cell

    # restricted peano index over active cells (raytrace_utils.c:388-571)
    peano = hp.nest2peano(np.arange(nbc, dtype=np.int64), cfg.bundleOrder)
    act_sorted = cells_present[np.argsort(peano[cells_present])]
    nest2rpi = np.full(nbc, -1, np.int64)
    nest2rpi[act_sorted] = np.arange(len(act_sorted))
    rpi2nest = np.full(nbc, -1, np.int64)
    rpi2nest[: len(act_sorted)] = act_sorted

    rec = np.zeros(len(nest), RAY_DTYPE)
    rec["nest"] = nest
    rec["n"] = packed[0:3].T
    rec["beta"] = packed[3:6].T
    rec["A"] = packed[6:10].T
    rec["Aprev"] = packed[10:14].T
    rec["alpha"] = packed[14:16].T
    rec["U"] = packed[16:20].T
    rec["phi"] = packed[20]

    path = os.path.join(output_path, filename)
    with open(path, "wb") as fp:
        fp.write(struct.pack("<ii", ntasks, 1))
        fp.write(bytes(rtd))
        fp.write(struct.pack("<q", nbc))
        fp.write(bc.tobytes())
        fp.write(nest2rpi.tobytes())
        fp.write(rpi2nest.tobytes())
        fp.write(struct.pack("<q", len(act_sorted)))
        fp.write(np.zeros(ntasks, "<i8").tobytes())
        fp.write(np.full(ntasks, len(act_sorted) - 1, "<i8").tobytes())
        fp.write(struct.pack("<i", PRIMARY_BUNDLECELL))
        fp.write(rec.tobytes())
    return path
