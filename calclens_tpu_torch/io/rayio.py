"""Ray output in the reference's FITS and binary layouts (rayio.c:255-1046).

Port of calclens_tpu/io/rayio.py on one device.

File <OutputPath>/<RayOutputName>%04d.%04d (CurrentMapNum, fileNum):
  primary image HDU: int64 [2*NbundleCells] = concat(NumRaysInPeanoCell,
      StartRaysInPeanoCell), keys NumFiles, PeanoCellHEALPixOrder,
      RayHEALPixOrder;
  BINTABLE "Rays": nest (K), ra, dec, A00, A01, A10, A11 (D)
      [+ alpha0, alpha1 when OutputRayDeflections] [+ phi when OutputPhi],
  rows grouped by bundle-cell Peano index, nest-ordered within a cell.
RayOutputFormat "bin" writes the same rows in the framed binary container
of file_write_rays2bin.  Rays are written in the observer frame and ra-dec
basis (rayio.c:299-347).

Two writers share the layout helpers:

- `write_rays`: takes a Rays view and its nest indices (small runs, tests).
- `write_rays_sharded`: the driver's writer, from the packed [21, N] buffer
  on its device.  The sort by (Peano cell, nest within the cell) is one
  sort of an int64 key on the device; the observer-frame transform
  (rays/soa.output_rows_obs_radec) and each file's row gather run on the
  device in column chunks, and only [10, chunk] blocks reach the host,
  through a pinned buffer on a GPU.  On a mesh (parallel/sharding.py) the
  rows of each chunk of a file are gathered from the ranks that hold them
  to the file's writing rank, which then runs the one-device chunk, so the
  files are byte-equal to a one-device run's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..healpix import core as hp
from ..healpix import torchhp
from ..rays import frames
from ..rays import soa
from . import fits

# rays per device block of the packed writer (gather + transform + copy)
WRITE_CHUNK = 1 << 24


# ----------------------------------------------------------------------------
# shared layout helpers
# ----------------------------------------------------------------------------

def _file_cell_groups(counts, nfiles):
    """Split peano cells into nfiles contiguous groups with roughly equal ray
    counts (the reference's per-file task decomposition)."""
    nbc = len(counts)
    csum = np.cumsum(counts)
    total = csum[-1]
    edges = np.searchsorted(csum, total * np.arange(1, nfiles) / nfiles) + 1
    return np.split(np.arange(nbc), edges)


def _layout_arrays(counts, cells, nbc):
    """(NumRaysInPeanoCell, StartRaysInPeanoCell) for one file covering
    `cells` (peano indices)."""
    fc = np.zeros(nbc, dtype=np.int64)
    fc[cells] = counts[cells]
    start = np.zeros(nbc, dtype=np.int64)
    np.cumsum(fc[:-1], out=start[1:])
    start[fc == 0] = 0
    return fc, start


def _ray_fields(defl, phi):
    fields = [("nest", "<i8"), ("ra", "<f8"), ("dec", "<f8"),
              ("A00", "<f8"), ("A01", "<f8"), ("A10", "<f8"), ("A11", "<f8")]
    if defl:
        fields += [("alpha0", "<f8"), ("alpha1", "<f8")]
    if phi:
        fields += [("phi", "<f8")]
    return np.dtype(fields)


def _file_header(cfg, nfiles):
    return {
        "NumFiles": (nfiles, "number of files that rays are split into"),
        "PeanoCellHEALPixOrder": (cfg.bundleOrder,
                                  "HEALPix order of peano indexed cells"),
        "RayHEALPixOrder": (cfg.rayOrder, "HEALPix order of ray grid"),
    }


def _make_rec(cfg, nest, n, A00, A01, A10, A11, alpha0, alpha1, phi):
    """Build one file's (or block's) structured row array.  `n` is [rows, 3]
    float64; ra/dec are derived here on the host in float64."""
    theta, phival = hp.vec2ang(n)
    ra, dec = hp.ang2radec(theta, phival)
    rec = np.zeros(len(nest), dtype=_ray_fields(cfg.OutputRayDeflections,
                                                cfg.OutputPhi))
    rec["nest"] = nest
    rec["ra"] = ra
    rec["dec"] = dec
    rec["A00"] = A00
    rec["A01"] = A01
    rec["A10"] = A10
    rec["A11"] = A11
    if cfg.OutputRayDeflections:
        rec["alpha0"] = alpha0
        rec["alpha1"] = alpha1
    if cfg.OutputPhi:
        rec["phi"] = phi
    return rec


def _ray_path(cfg, map_num, fileNum):
    return os.path.join(
        cfg.OutputPath, f"{cfg.RayOutputName}{map_num:04d}.{fileNum:04d}")


# ----------------------------------------------------------------------------
# binary (non-FITS) container: file_write_rays2bin (rayio.c:828-1046)
# ----------------------------------------------------------------------------
#
# Record stream, each block framed by int32 markers holding its byte count
# (the Fortran-unformatted convention; the reference sets only the last
# marker, and readers of either file skip 4 bytes regardless):
#   [i4] IOheader{NumFiles i8, PeanoCellHEALPixOrder i8, RayHEALPixOrder i8,
#                 flag_defl i8, flag_phi i8, pad to 256 B} [i4]
#   [i4] NumRaysInPeanoCell   i8[NbundleCells] [i4]
#   [i4] StartRaysInPeanoCell i8[NbundleCells] [i4]
#   [i4] packed ray records (same fields/order as the FITS bintable) [i4]

_BIN_HEADER_BYTES = 256


def _bin_header(cfg, nfiles):
    hdr = np.zeros(_BIN_HEADER_BYTES, np.uint8)
    hdr[:40] = np.frombuffer(
        np.array([nfiles, cfg.bundleOrder, cfg.rayOrder,
                  int(bool(cfg.OutputRayDeflections)),
                  int(bool(cfg.OutputPhi))], "<i8").tobytes(), np.uint8)
    return hdr.tobytes()


def _marker(nbytes):
    return np.array([nbytes], "<i4").tobytes()


def _write_bin_file(path, cfg, nfiles, fc, start, rec):
    with open(path, "wb") as fp:
        hdr = _bin_header(cfg, nfiles)
        fp.write(_marker(len(hdr)) + hdr + _marker(len(hdr)))
        for arr in (fc, start):
            b = np.asarray(arr, "<i8").tobytes()
            fp.write(_marker(len(b)) + b + _marker(len(b)))
        # the records straight from their buffer (no bytes copy)
        fp.write(_marker(rec.nbytes))
        rec.tofile(fp)
        fp.write(_marker(rec.nbytes))


def read_rays_bin(path):
    """Read one binary ray file -> (header dict, NumRaysInPeanoCell,
    StartRaysInPeanoCell, structured row array), the mirror of read_rays."""
    with open(path, "rb") as fp:
        raw = fp.read()
    off = 4
    nf, bo, ro, fd, fph = np.frombuffer(raw[off: off + 40], "<i8")
    hdr = {"NumFiles": int(nf), "PeanoCellHEALPixOrder": int(bo),
           "RayHEALPixOrder": int(ro), "flag_defl": int(fd),
           "flag_phi": int(fph)}
    off += _BIN_HEADER_BYTES + 8
    nbc = int(hp.order2npix(bo))
    counts = np.frombuffer(raw[off: off + 8 * nbc], "<i8")
    off += 8 * nbc + 8
    starts = np.frombuffer(raw[off: off + 8 * nbc], "<i8")
    off += 8 * nbc + 8
    dt = _ray_fields(fd, fph)
    nrows = int(counts.sum())
    rec = np.frombuffer(raw[off: off + nrows * dt.itemsize], dt)
    return hdr, counts, starts, rec


def _emit_ray_file(cfg, path, nfiles, fc, start, rec):
    """Write one output file in cfg.RayOutputFormat ('fits' | 'bin')."""
    if cfg.RayOutputFormat.lower() in ("bin", "binary"):
        _write_bin_file(path, cfg, nfiles, fc, start, rec)
    else:
        prim = fits.image_hdu(np.concatenate([fc, start]),
                              header=_file_header(cfg, nfiles))
        fits.write_fits(path, [prim, fits.bintable_hdu(rec, name="Rays")])


# ----------------------------------------------------------------------------
# writer of a Rays view
# ----------------------------------------------------------------------------

def _to_obs_radec(cfg, rays, ray_nest):
    obs = torch.as_tensor(hp.pix2vec_nest(ray_nest, cfg.rayOrder),
                          dtype=rays.n.dtype, device=rays.n.device)
    return frames.rot_rays_ang2radec(frames.paratrans_rays_curr2obs(rays,
                                                                     obs))


def write_rays(cfg, rays, ray_nest, map_num=0):
    """Write all rays of a Rays view (torch tensors or numpy arrays, any
    float dtype; ray_nest the host nest index per ray) to
    cfg.NumRayOutputFiles files.  Returns the paths."""
    rays = type(rays)(*(torch.as_tensor(x) for x in rays))
    out = _to_obs_radec(cfg, rays, ray_nest)

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    n, A, alpha, phi = host(out.n), host(out.A), host(out.alpha), host(out.phi)
    nest = np.asarray(ray_nest, np.int64)
    k2 = 2 * (cfg.rayOrder - cfg.bundleOrder)
    nbc = int(hp.order2npix(cfg.bundleOrder))
    cell_peano = hp.nest2peano(nest >> k2, cfg.bundleOrder)
    # sort rows by (peano cell, nest within cell): the reference's layout
    order = np.lexsort((nest, cell_peano))
    counts = np.bincount(cell_peano, minlength=nbc).astype(np.int64)
    nfiles = max(1, int(cfg.NumRayOutputFiles))
    os.makedirs(cfg.OutputPath, exist_ok=True)
    paths = []
    row0 = 0
    for fileNum, cells in enumerate(_file_cell_groups(counts, nfiles)):
        fc, start = _layout_arrays(counts, cells, nbc)
        nrows = int(fc.sum())
        rows = order[row0: row0 + nrows]
        rec = _make_rec(cfg, nest[rows], n[rows],
                        A[rows, 0, 0], A[rows, 0, 1],
                        A[rows, 1, 0], A[rows, 1, 1],
                        alpha[rows, 0], alpha[rows, 1], phi[rows])
        path = _ray_path(cfg, map_num, fileNum)
        _emit_ray_file(cfg, path, nfiles, fc, start, rec)
        paths.append(path)
        row0 += nrows
    return paths


# ----------------------------------------------------------------------------
# the driver's writer (packed buffer on its device)
# ----------------------------------------------------------------------------

def _sorted_layout(cfg, N, ray_nest, device):
    """Device sort of the rays by (Peano cell, nest within the cell): returns
    (storage index per output row [N] int64, sorted key [N] int64 with the
    cell's Peano index above the 2 k bits of the nest within the cell,
    host rays per Peano cell [nbc])."""
    order = cfg.rayOrder
    k2 = 2 * (order - cfg.bundleOrder)
    nbc = int(hp.order2npix(cfg.bundleOrder))
    if ray_nest is None:
        # full sky in RING storage order: slot i is RING pixel i
        nest = torchhp.ring2nest_dev(
            torch.arange(N, dtype=torch.int32, device=device), order).long()
    else:
        nest = torch.as_tensor(np.asarray(ray_nest, np.int64), device=device)
    peano_of_cell = torch.as_tensor(
        hp.nest2peano(np.arange(nbc, dtype=np.int64), cfg.bundleOrder),
        device=device)
    key = (peano_of_cell[nest >> k2] << k2) | (nest & ((1 << k2) - 1))
    del nest
    counts = torch.bincount(key >> k2, minlength=nbc).cpu().numpy()
    key, rows = torch.sort(key)
    return rows, key, counts.astype(np.int64)


def _host_block(x):
    """[10, c] device block -> host float64 numpy (through a pinned buffer
    on a GPU)."""
    if x.device.type == "cuda":
        pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        pinned.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        x = pinned
    return x.numpy().astype(np.float64)


def _gather_chunk(mesh, rays_packed, bounds, idx, writer):
    """The columns idx (global storage slots, [c]) of the ray buffer, in
    that order, on rank `writer` (None on the others): each rank sends the
    ones it holds (calclens_tpu/io/rayio.py's per-file row gathers)."""
    r = mesh.rank
    b = torch.as_tensor(np.asarray(bounds[1:-1]), device=idx.device)
    owner = torch.bucketize(idx, b, right=True)
    counts = torch.bincount(owner, minlength=mesh.size).cpu().numpy()
    mine = owner == r
    piece = rays_packed.index_select(1, idx[mine] - int(bounds[r]))
    got = mesh.gather_to(piece, counts, writer)
    if got is None:
        return None
    out = torch.empty((rays_packed.shape[0], idx.shape[0]),
                      dtype=rays_packed.dtype, device=rays_packed.device)
    out[:, torch.sort(owner, stable=True).indices] = got
    return out


def write_rays_sharded(cfg, rays_packed, ray_nest=None, map_num=0,
                       mesh=None, bounds=None):
    """Write all rays from the packed [21, N] buffer on its device, or on a
    mesh from this rank's columns bounds[rank] .. bounds[rank + 1] of it
    (the JAX package's sharded writer).

    ray_nest None means the full-sky grid in RING storage order; otherwise
    it is the host nest index per storage slot (ra-dec boxes, legacy
    restarts).  The layout is write_rays'; the values are the device
    transform's, in the buffer's dtype.  On a mesh, file f is written by
    rank f mod n, from its chunks' columns gathered to it.  Returns the
    paths (on a mesh, of the files this rank wrote)."""
    N = int(rays_packed.shape[1] if mesh is None else bounds[-1])
    device = rays_packed.device
    order = cfg.rayOrder
    k2 = 2 * (order - cfg.bundleOrder)
    nbc = int(hp.order2npix(cfg.bundleOrder))
    nfiles = max(1, int(cfg.NumRayOutputFiles))
    rows, key, counts = _sorted_layout(cfg, N, ray_nest, device)
    nest_of_peano = np.empty(nbc, np.int64)
    nest_of_peano[hp.nest2peano(np.arange(nbc, dtype=np.int64),
                                cfg.bundleOrder)] = np.arange(nbc)
    nest_of_peano = torch.as_tensor(nest_of_peano, device=device)
    os.makedirs(cfg.OutputPath, exist_ok=True)
    paths = []
    row0 = 0
    for fileNum, cells in enumerate(_file_cell_groups(counts, nfiles)):
        fc, start = _layout_arrays(counts, cells, nbc)
        nrows = int(fc.sum())
        me = mesh is None or fileNum % mesh.size == mesh.rank
        rec = np.zeros(nrows if me else 0, dtype=_ray_fields(
            cfg.OutputRayDeflections, cfg.OutputPhi))
        for a in range(0, nrows, WRITE_CHUNK):
            b = min(nrows, a + WRITE_CHUNK)
            idx = rows[row0 + a: row0 + b]
            if mesh is None:
                chunk = rays_packed.index_select(1, idx)
            else:
                chunk = _gather_chunk(mesh, rays_packed, bounds, idx,
                                      fileNum % mesh.size)
            if not me:
                continue
            kk = key[row0 + a: row0 + b]
            nest = (nest_of_peano[kk >> k2] << k2) | (kk & ((1 << k2) - 1))
            ring = (idx if ray_nest is None
                    else torchhp.nest2ring_dev(nest, order).long())
            cols = soa.output_rows_obs_radec(chunk, ring, order)
            del chunk
            blk = _host_block(cols)
            rec[a:b] = _make_rec(cfg, nest.cpu().numpy(), blk[0:3].T,
                                 *blk[3:10])
        if me:
            path = _ray_path(cfg, map_num, fileNum)
            _emit_ray_file(cfg, path, nfiles, fc, start, rec)
            paths.append(path)
        row0 += nrows
    if mesh is not None:
        mesh.barrier()
    return paths


def read_rays(path):
    """Read one FITS ray file -> (header, NumRaysInPeanoCell,
    StartRaysInPeanoCell, structured row array)."""
    hdus = fits.read_fits(path)
    hdr, layout = hdus[0]
    nbc = len(layout) // 2
    return hdr, layout[:nbc], layout[nbc:], hdus[1][1]
