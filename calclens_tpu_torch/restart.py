"""Checkpoint / resume (reference restart.c) in two formats.

The npz restart: the npz half of calclens_tpu/restart.py, with the same
keys and the same compatibility fields, so a restart.npz written by either
package resumes in the other.

The sharded checkpoint: the port of the JAX package's orbax checkpoint
(write_restart_orbax / read_restart_orbax), in a format of its own.  A
directory holds one plain .npy per writing rank, rays.<rank>.npy, that
rank's [21, c_r] packed ray columns in the run's dtype (and nest.<rank>.npy,
its int64 slice of the ray nest index, when the run has one), and
meta.json, written last: the compatibility values, current_plane, map_num,
the total column count, the writers' column bounds, the dtype and whether
a nest is stored.  Each rank writes only its own columns and each reader
reads only the parts of the shards that overlap its own, so a run saved on
n ranks resumes on any number of ranks (the elasticity the reference's
NTasks-pinned restart forbids) and no rank holds the whole buffer.

Both formats are written atomically: into <path>.tmp, then the previous
checkpoint moves to <path>.bak and the new one takes its name
(restart.c:38-53).  Both refuse a config whose compatibility fields differ:
the fields that change the physics or the layout (restart.c:66-124).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_COMPAT_FIELDS = (
    "OmegaM", "maxComvDistance", "NumLensPlanes", "rayOrder", "bundleOrder",
    "SHTOrder", "minRa", "maxRa", "minDec", "maxDec",
)
# the sharded checkpoint's metadata file
META = "meta.json"
# bytes of the host staging buffer between a device and a shard file
STAGING_BYTES = 1 << 26


def _compat(cfg):
    return [float(getattr(cfg, f)) for f in _COMPAT_FIELDS]


def _check_compat(stored, cfg):
    bad = np.flatnonzero(~np.isclose(np.asarray(stored), _compat(cfg)))
    if len(bad):
        names = [_COMPAT_FIELDS[i] for i in bad]
        raise ValueError(f"restart incompatible with config: {names}")


def write_restart(path, cfg, rays, ray_nest, current_plane, map_num=0):
    """Atomic write of a host Rays view: .tmp then rename; the previous file
    is kept as .bak (restart.c:38-53)."""
    tmp = path + ".tmp"
    np.savez(
        tmp,
        n=np.asarray(rays.n), beta=np.asarray(rays.beta),
        A=np.asarray(rays.A), Aprev=np.asarray(rays.Aprev),
        alpha=np.asarray(rays.alpha), U=np.asarray(rays.U),
        phi=np.asarray(rays.phi),
        ray_nest=np.asarray(ray_nest),
        current_plane=np.int64(current_plane),
        map_num=np.int64(map_num),
        compat=np.array(_compat(cfg)),
    )
    saved = tmp if tmp.endswith(".npz") else tmp + ".npz"
    if os.path.exists(path):
        os.replace(path, path + ".bak")
    os.replace(saved, path)


def read_restart(path, cfg, dtype=np.float32):
    """Returns (rays, ray_nest, current_plane, map_num) with rays a host
    Rays view of numpy arrays; raises on a config mismatch."""
    from .rays.propagate import Rays

    with np.load(path) as z:
        _check_compat(z["compat"], cfg)
        ndt = np.dtype(dtype)
        rays = Rays(
            n=np.asarray(z["n"], ndt), beta=np.asarray(z["beta"], ndt),
            A=np.asarray(z["A"], ndt), Aprev=np.asarray(z["Aprev"], ndt),
            alpha=np.asarray(z["alpha"], ndt), U=np.asarray(z["U"], ndt),
            phi=np.asarray(z["phi"], ndt),
        )
        return (rays, z["ray_nest"].copy(), int(z["current_plane"]),
                int(z["map_num"]))


def _shard_names(rank):
    return f"rays.{rank:05d}.npy", f"nest.{rank:05d}.npy"


def _np_dtype(t):
    return torch.empty(0, dtype=t).numpy().dtype


def _torch_dtype(d):
    return torch.from_numpy(np.empty(0, d)).dtype


def _staging(n, dtype, device):
    """A host buffer of n elements (page-locked when the device is CUDA)
    and its numpy view."""
    buf = torch.empty(n, dtype=dtype, pin_memory=device.type == "cuda")
    return buf, buf.numpy()


def _write_npy(fn, x):
    """x (a tensor on any device, or a numpy array) as a plain .npy, its
    elements streamed through a host buffer of at most STAGING_BYTES: no
    host copy of a device tensor is made whole."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = x.contiguous()
    flat = x.reshape(-1)
    header = {"descr": np.lib.format.dtype_to_descr(_np_dtype(x.dtype)),
              "fortran_order": False, "shape": tuple(x.shape)}
    with open(fn, "wb") as fp:
        np.lib.format.write_array_header_1_0(fp, header)
        step = max(1, STAGING_BYTES // x.element_size())
        buf, view = _staging(min(step, flat.numel()), x.dtype, x.device)
        for a in range(0, flat.numel(), step):
            m = min(step, flat.numel() - a)
            buf[:m].copy_(flat[a:a + m])
            fp.write(memoryview(view[:m]))


def _npy_layout(fn):
    """(shape, dtype, byte offset of the data) of a plain .npy file."""
    with open(fn, "rb") as fp:
        major, _ = np.lib.format.read_magic(fp)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(fp)
        if fortran:
            raise ValueError(f"{fn}: Fortran-ordered array")
        return shape, dtype, fp.tell()


def write_restart_sharded(path, cfg, cols, nest, current_plane, map_num,
                          bounds, rank=0, mesh=None):
    """Write this rank's part of a sharded checkpoint at `path`: cols, the
    rank's [21, bounds[rank + 1] - bounds[rank]] packed ray columns (a
    tensor on its device, or a numpy array), and nest, its slice of the
    ray nest index (None on the full sky).  Rank 0 then writes meta.json
    and puts the directory in place (the previous one kept as
    <path>.bak).  On a mesh (parallel.sharding.Mesh) the ranks meet twice,
    each time passing one small object (whether their part succeeded), and
    no ray data moves between them; without one, the call for rank 0
    commits, so in one process the other ranks' parts are written
    first."""
    bounds = np.asarray(bounds, np.int64)
    tmp = path + ".tmp"
    rays_fn, nest_fn = _shard_names(rank)
    err = None
    try:
        c = int(bounds[rank + 1] - bounds[rank])
        if tuple(cols.shape) != (21, c):
            raise ValueError(f"rank {rank} columns {tuple(cols.shape)}, "
                             f"bounds give (21, {c})")
        if nest is not None and len(nest) != c:
            raise ValueError(f"rank {rank} nest of {len(nest)}, bounds "
                             f"give {c}")
        os.makedirs(tmp, exist_ok=True)
        _write_npy(os.path.join(tmp, rays_fn), cols)
        if nest is not None:
            _write_npy(os.path.join(tmp, nest_fn),
                       np.asarray(nest, np.int64))
    except (OSError, ValueError) as e:
        err = f"rank {rank}: {e!r}"
    if mesh is not None:
        errs = [e for e in mesh.all_gather_object(err) if e is not None]
    else:
        errs = [] if err is None else [err]
    if errs:
        raise OSError(f"sharded checkpoint {path} not written: {errs}")
    if rank == 0:
        try:
            dtype = (cols.dtype if isinstance(cols, np.ndarray)
                     else _np_dtype(cols.dtype))
            _commit(path, cfg, bounds, np.dtype(dtype), nest is not None,
                    current_plane, map_num)
        except (OSError, ValueError) as e:
            err = f"rank 0: {e!r}"
    if mesh is not None:
        err = mesh.broadcast_object(err, 0)
    if err is not None:
        raise OSError(f"sharded checkpoint {path} not committed: {err}")


def _commit(path, cfg, bounds, dtype, has_nest, current_plane, map_num):
    """Rank 0's end of a write: every shard in <path>.tmp checked against
    the bounds, anything else there removed, meta.json written, then the
    old checkpoint to <path>.bak and <path>.tmp to <path>."""
    tmp = path + ".tmp"
    want = set()
    for r in range(len(bounds) - 1):
        names = _shard_names(r)
        c = int(bounds[r + 1] - bounds[r])
        for fn, shape, dt in ((names[0], (21, c), dtype),
                              (names[1], (c,), np.dtype(np.int64))):
            if fn == names[1] and not has_nest:
                continue
            got = _npy_layout(os.path.join(tmp, fn))[:2]
            if got != (shape, dt):
                raise ValueError(f"{tmp}/{fn}: {got}, expected "
                                 f"{(shape, dt)}")
            want.add(fn)
    for fn in os.listdir(tmp):
        if fn not in want:
            p = os.path.join(tmp, fn)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    meta = dict(compat=_compat(cfg), current_plane=int(current_plane),
                map_num=int(map_num), columns=int(bounds[-1]),
                bounds=[int(b) for b in bounds], dtype=dtype.str,
                nest=bool(has_nest))
    with open(os.path.join(tmp, META), "w") as fp:
        json.dump(meta, fp)
    bak = path + ".bak"
    if os.path.exists(path):
        if os.path.exists(bak):
            shutil.rmtree(bak)
        os.replace(path, bak)
    os.replace(tmp, path)


def read_sharded_meta(path, cfg):
    """The checkpoint's meta.json, checked against cfg (ValueError naming
    the fields that differ).  A <path>.tmp, or a directory without
    meta.json (an interrupted write), raises ValueError naming it; no
    directory, FileNotFoundError."""
    path = os.path.normpath(path)
    if path.endswith(".tmp"):
        raise ValueError(f"{path} is an unfinished sharded checkpoint "
                         f"(a .tmp directory), not a checkpoint")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no sharded checkpoint at {path}")
    fn = os.path.join(path, META)
    if not os.path.isfile(fn):
        raise ValueError(f"{path} holds no {META}: an interrupted or "
                         f"foreign write, not a sharded checkpoint")
    with open(fn) as fp:
        meta = json.load(fp)
    _check_compat(meta["compat"], cfg)
    return meta


def _read_rows(fn, off, w, lo, hi, out, stage):
    """Columns [lo, hi) of the [21, w] shard `fn`, whose data start at
    byte `off`, into out [21, hi - lo] (a tensor, any device and dtype),
    read row by row through `stage` (a host buffer and its numpy view, of
    the file's dtype): only those columns' bytes are read."""
    buf, view = stage
    step, size = len(view), view.itemsize
    with open(fn, "rb", buffering=0) as fp:
        for k in range(21):
            for a in range(lo, hi, step):
                m = min(step, hi - a)
                fp.seek(off + (k * w + a) * size)
                got = fp.readinto(memoryview(view[:m]).cast("B"))
                if got != m * size:
                    raise ValueError(f"{fn}: short read")
                src = buf[:m]
                if out.dtype != src.dtype:
                    # cast on the host, as read_restart casts
                    src = torch.from_numpy(view[:m].astype(
                        _np_dtype(out.dtype)))
                out[k, a - lo:a - lo + m].copy_(src)


def read_restart_sharded(path, cfg, columns=None, dtype=np.float32,
                         device="cpu"):
    """Read a sharded checkpoint written on any number of ranks.  columns:
    a function of the total column count N giving this reader's block (c0,
    c1) (all of them by default).  Returns (the [21, c1 - c0] packed
    columns in `dtype` on `device`, the whole ray nest index or None,
    current_plane, map_num).  Only the parts of the shards that overlap
    [c0, c1) are read, through a host buffer of at most STAGING_BYTES."""
    meta = read_sharded_meta(path, cfg)
    N = int(meta["columns"])
    c0, c1 = (0, N) if columns is None else (int(c) for c in columns(N))
    device = torch.device(device)
    out = torch.empty((21, c1 - c0), dtype=_torch_dtype(dtype),
                      device=device)
    fdt = _torch_dtype(meta["dtype"])
    stage = None
    wb = meta["bounds"]
    for r in range(len(wb) - 1):
        w0, w1 = wb[r], wb[r + 1]
        lo, hi = max(c0, w0), min(c1, w1)
        if hi <= lo:
            continue
        if stage is None:
            n = max(1, min(STAGING_BYTES // fdt.itemsize, c1 - c0))
            stage = _staging(n, fdt, device)
        fn = os.path.join(path, _shard_names(r)[0])
        shape, fd, off = _npy_layout(fn)
        if shape != (21, w1 - w0) or fd != np.dtype(meta["dtype"]):
            raise ValueError(f"{fn}: {shape} {fd}, meta gives "
                             f"{(21, w1 - w0)} {meta['dtype']}")
        _read_rows(fn, off, w1 - w0, lo - w0, hi - w0,
                   out[:, lo - c0:hi - c0], stage)
    nest = None
    if meta["nest"]:
        nest = np.concatenate([
            np.load(os.path.join(path, _shard_names(r)[1]))
            for r in range(len(wb) - 1)])
    return out, nest, int(meta["current_plane"]), int(meta["map_num"])
