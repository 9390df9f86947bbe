"""A 1-D mesh of ranks over torch.distributed, and every collective the
sharded plane step makes (port of calclens_tpu/parallel/sharding.py).

The JAX package carries every layout on one mesh axis and lets GSPMD insert
the collectives at its sharding constraints.  Here each such boundary is an
explicit call of a Mesh method, so this module states everything that
crosses ranks:

  * rays: contiguous column blocks of the packed [21, N] buffer (JAX
    P(None, AXIS)): blocks(N);
  * particles: contiguous row blocks (JAX `batch`): blocks(rows);
  * harmonic space: contiguous blocks of m, the rows of [nm, J] and the
    columns of alm [nl, nm] (JAX `m_rows`, `alm`): blocks(nm);
  * ring space: contiguous blocks of ring rows, chosen so that each rank's
    rings hold about npix / n pixels (JAX `rings`): rings(plan);
  * maps: equal contiguous blocks of RING pixels (JAX _cst_blocks and
    _cst_blocks1), the layout the deposit's reduce-scatter gives and the
    halo-exchange interpolation reads: blocks(npix).

  * patches and 3D grids: contiguous blocks of the leading axis, the
    multigrid patches [C, N, N] (JAX _cst_patch) and the x-slabs of the
    THREEDPOT grid (JAX slabfft's P(AXIS, None, None)): blocks(C),
    blocks(nfft).

Collectives (each rank calls each one in the same order):
  * reduce_scatter_blocks: the deposit's global sum onto pixel blocks
    (calclens_tpu/poisson.py _cst_blocks, the JAX psum_scatter);
  * reduce_scatter_rows, all_gather_rows: the same on the leading axis
    (the patch deposit's psum_scatter and the solved patches' all-gather,
    calclens_tpu/mgdriver.py; the THREEDPOT grid's slabs);
  * all_true: a flag that holds on every rank (the MGConvFact stop test,
    jnp.all over every patch in JAX);
  * rings_to_m / m_to_rings: the ring <-> m transposes of the analysis and
    the synthesis (calclens_tpu/sht/transforms.py _cst_rings2);
  * repartition: one contiguous partition of an axis to another, with
    uneven pieces (pixel blocks <-> the pixels of the rank's rings);
  * window: the columns [a - H, b + H) of a column-sharded array, from
    however many ranks hold them (the two-sided halo exchange of
    calclens_tpu/parallel/halo.py, and the multi-hop _halo_window of
    calclens_tpu/gals/gridsearch.py);
  * all_gather_cols: an axis gathered whole on every rank (the maps of a
    cut-sky ray side, as GSPMD gathers them in JAX);
  * gather_to: pieces of a column-sharded array sent to one rank (the ray
    writer's per-file row gathers, calclens_tpu/io/rayio.py);
  * all_gather_object, broadcast_object (host objects: the galaxy images,
    rank 0's restart decisions), barrier.

Every tensor collective goes through three primitives (_all_to_all,
_reduce_scatter, _all_gather) on flat real tensors; complex tensors travel
as their real views.  The caller chooses the backend and the device
(make_mesh): nothing here switches backend or moves a buffer to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def pad_to_multiple(n: int, k: int) -> int:
    """n rounded up to a multiple of k (calclens_tpu/parallel/sharding.py's,
    held to it by tests/test_torch_copies.py)."""
    return ((n + k - 1) // k) * k


def block_bounds(total: int, n: int) -> np.ndarray:
    """[n + 1] bounds of n contiguous blocks of ceil(total / n) (the last
    ones shorter or empty), the JAX NamedSharding's blocks of an axis."""
    b = -(-int(total) // n) if total else 0
    return np.minimum(np.arange(n + 1, dtype=np.int64) * b, int(total))


def ring_bounds(startpix, nrings: int, npix: int, n: int) -> np.ndarray:
    """[n + 1] ring-row bounds: rank k takes the rings from the first whose
    start is nearest k npix / n, so each rank's rings hold about npix / n
    pixels, and the rings' pixels lie near the rank's pixel block."""
    sp = np.asarray(startpix[:nrings], np.int64)
    out = np.zeros(n + 1, np.int64)
    for k in range(1, n):
        t = k * npix / n
        i = int(np.searchsorted(sp, t))
        if i > 0 and (i == nrings or t - sp[i - 1] < sp[i] - t):
            i -= 1
        out[k] = max(out[k - 1], min(i, nrings))
    out[n] = nrings
    return out


def _real(x):
    return torch.view_as_real(x) if x.is_complex() else x


def _flat(x):
    return _real(x.contiguous()).reshape(-1)


class Mesh:
    """This rank's place on a 1-D mesh of `size` ranks (`group`, None for
    the default group), each on its own `device`."""

    def __init__(self, device, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        # the number of calls of each collective (the tests and chip_smoke
        # read them)
        self.calls = {}

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    # ------------------------------------------------------------------
    # block bounds of the sharded families
    # ------------------------------------------------------------------
    def blocks(self, total: int) -> np.ndarray:
        """[n + 1] bounds of the ranks' contiguous blocks of an axis of
        `total` (block_bounds): the ray columns, particle rows, m rows and
        pixels."""
        return block_bounds(total, self.size)

    def block(self, total: int):
        """(a, b): this rank's block of an axis of `total`."""
        b = self.blocks(total)
        return int(b[self.rank]), int(b[self.rank + 1])

    def rings(self, plan) -> np.ndarray:
        return ring_bounds(plan.startpix, plan.nrings, plan.npix, self.size)

    # ------------------------------------------------------------------
    # primitives: flat, contiguous, real tensors on self.device
    # ------------------------------------------------------------------
    def _count(self, name):
        self.calls[name] = self.calls.get(name, 0) + 1

    def _all_to_all(self, out, inp, out_splits, in_splits):
        dist.all_to_all_single(out, inp, out_splits, in_splits,
                               group=self.group)

    def _reduce_scatter(self, out, inp):
        dist.reduce_scatter_tensor(out, inp, group=self.group)

    def _all_gather(self, out, inp):
        dist.all_gather_into_tensor(out, inp, group=self.group)

    # ------------------------------------------------------------------
    # the exchange every layout change reduces to
    # ------------------------------------------------------------------
    def exchange(self, send, recv_numel, dtype):
        """send[d]: the tensor (any shape, real or complex) for rank d;
        recv_numel[s]: the elements (complex ones counted once) coming
        from rank s, all of `dtype`.  Returns the flat received pieces,
        one per source rank, in `dtype`."""
        self._count("all_to_all")
        cplx = torch.empty((), dtype=dtype).is_complex()
        k = 2 if cplx else 1
        rdt = torch.empty((), dtype=dtype).real.dtype if cplx else dtype
        flat = [_flat(x.to(dtype)) for x in send]
        in_splits = [int(x.numel()) for x in flat]
        out_splits = [k * int(c) for c in recv_numel]
        inp = (torch.cat(flat) if flat else
               torch.empty(0, dtype=rdt, device=self.device))
        out = torch.empty(sum(out_splits), dtype=rdt, device=self.device)
        self._all_to_all(out, inp, out_splits, in_splits)
        pieces = list(torch.split(out, out_splits))
        if cplx:
            pieces = [torch.view_as_complex(p.reshape(-1, 2)) for p in pieces]
        return pieces

    # ------------------------------------------------------------------
    # collectives of the plane step
    # ------------------------------------------------------------------
    def reduce_scatter_blocks(self, x):
        """x [..., T] (each rank's full partial sums) -> [..., b - a] the
        sums over ranks of this rank's block (blocks(T)) of the last axis:
        one reduce-scatter (the last block padded with zeros)."""
        self._count("reduce_scatter")
        n = self.size
        T = x.shape[-1]
        B = -(-T // n)
        lead = x.shape[:-1]
        xp = torch.nn.functional.pad(x, (0, n * B - T)) if n * B > T else x
        inp = xp.reshape(lead + (n, B)).movedim(-2, 0)
        out = torch.empty(lead + (B,), dtype=x.dtype, device=x.device)
        self._reduce_scatter(_real(out).reshape(-1), _flat(inp))
        a, b = self.block(T)
        return out[..., : b - a]

    def reduce_scatter_rows(self, x):
        """x [T, ...] (each rank's full partial sums) -> [b - a, ...] the
        sums over ranks of this rank's block (blocks(T)) of the leading
        axis: one reduce-scatter of x as it lies (its blocks are
        contiguous; a copy only to pad T to n equal blocks)."""
        self._count("reduce_scatter")
        n = self.size
        T = x.shape[0]
        B = -(-T // n)
        if n * B > T:
            x = torch.cat([x, x.new_zeros((n * B - T,) + x.shape[1:])])
        out = torch.empty((B,) + x.shape[1:], dtype=x.dtype, device=x.device)
        self._reduce_scatter(_real(out).reshape(-1), _flat(x))
        a, b = self.block(T)
        return out[: b - a]

    def all_gather_rows(self, x, bounds):
        """x [b - a, ...] (this rank's block of the leading axis under
        `bounds`) -> [T, ...] the whole axis on every rank: one all-gather
        of blocks padded to the longest (the result itself when the blocks
        are equal)."""
        self._count("all_gather")
        n = self.size
        sizes = np.diff(bounds)
        w = int(sizes.max())
        if x.shape[0] < w:
            x = torch.cat([x, x.new_zeros((w - x.shape[0],) + x.shape[1:])])
        out = torch.empty((n * w,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        self._all_gather(_real(out).reshape(-1), _flat(x))
        if np.all(sizes == w):
            return out
        return torch.cat([out[d * w: d * w + int(sizes[d])]
                          for d in range(n)])

    def all_true(self, flag):
        """flag: a bool tensor (one element) on this rank -> True when it
        holds on every rank (one all-gather of one float; the host waits
        for it)."""
        self._count("all_gather")
        out = torch.empty(self.size, dtype=torch.float32, device=flag.device)
        self._all_gather(out, flag.reshape(1).to(torch.float32))
        return bool(torch.all(out > 0))

    def repartition(self, x, src, dst):
        """x [..., src[r + 1] - src[r]]: this rank's part of an axis under
        the contiguous partition `src` -> its part under `dst` ([n + 1]
        bounds each, of the same total)."""
        r, n = self.rank, self.size
        lead = x.shape[:-1]
        lw = int(np.prod(lead)) if lead else 1
        send, recv = [], []
        for d in range(n):
            lo, hi = max(src[r], dst[d]), min(src[r + 1], dst[d + 1])
            send.append(x[..., lo - src[r]: hi - src[r]] if hi > lo
                        else x[..., :0])
            lo, hi = max(src[d], dst[r]), min(src[d + 1], dst[r + 1])
            recv.append(max(0, hi - lo) * lw)
        pieces = self.exchange(send, recv, x.dtype)
        return torch.cat([p.reshape(lead + (recv[s] // lw,))
                          for s, p in enumerate(pieces)], dim=-1)

    def rings_to_m(self, G, rings, mb):
        """The analysis transpose: G [..., rows_r, nm] (this rank's ring
        rows rings[r]..rings[r + 1], every m) -> [..., nrings, m1 - m0]
        (every ring row, this rank's m block of mb = blocks(nm))."""
        r, n = self.rank, self.size
        lead = G.shape[:-2]
        lw = int(np.prod(lead)) if lead else 1
        send = [G[..., mb[d]: mb[d + 1]] for d in range(n)]
        recv = [int(rings[s + 1] - rings[s]) * int(mb[r + 1] - mb[r]) * lw
                for s in range(n)]
        pieces = self.exchange(send, recv, G.dtype)
        nmr = int(mb[r + 1] - mb[r])
        return torch.cat([p.reshape(lead + (int(rings[s + 1] - rings[s]),
                                            nmr))
                          for s, p in enumerate(pieces)], dim=-2)

    def m_to_rings(self, Q, row0, rings, mb):
        """The synthesis transpose: Q [..., R, m1 - m0] (ring rows row0 ..
        row0 + R, this rank's m block) -> ([..., rows, nm] of those rows
        that lie in this rank's ring rows, (lo, hi) their ring range)."""
        r, n = self.rank, self.size
        R = Q.shape[-2]
        lead = Q.shape[:-2]
        lw = int(np.prod(lead)) if lead else 1

        def part(d):
            return (max(row0, int(rings[d])),
                    min(row0 + R, int(rings[d + 1])))

        send = []
        for d in range(n):
            lo, hi = part(d)
            send.append(Q[..., lo - row0: hi - row0, :] if hi > lo
                        else Q[..., :0, :])
        lo, hi = part(r)
        rows = max(0, hi - lo)
        recv = [rows * int(mb[s + 1] - mb[s]) * lw for s in range(n)]
        pieces = self.exchange(send, recv, Q.dtype)
        out = torch.cat([p.reshape(lead + (rows, int(mb[s + 1] - mb[s])))
                         for s, p in enumerate(pieces)], dim=-1)
        return out, (lo, max(lo, hi))

    def window_bounds(self, bounds, H: int):
        """[(lo, hi)] per rank: the columns [a - H, b + H) of its block,
        clipped to the axis."""
        T = int(bounds[-1])
        return [(max(0, int(bounds[d]) - H), min(T, int(bounds[d + 1]) + H))
                for d in range(self.size)]

    def window(self, x, bounds, H: int):
        """x [..., b - a] (this rank's block under `bounds`) -> ([..., hi -
        lo] the columns [lo, hi) = [a - H, b + H) clipped to the axis, lo):
        the two-sided halo exchange, from every rank whose block meets the
        window, so a halo wider than a block takes its columns from
        several ranks (the multi-hop exchange)."""
        r, n = self.rank, self.size
        win = self.window_bounds(bounds, H)
        a, b = int(bounds[r]), int(bounds[r + 1])
        lead = x.shape[:-1]
        lw = int(np.prod(lead)) if lead else 1
        send, recv = [], []
        for d in range(n):
            if d == r:
                send.append(x[..., :0])
                recv.append(0)
                continue
            lo, hi = max(a, win[d][0]), min(b, win[d][1])
            send.append(x[..., lo - a: hi - a] if hi > lo else x[..., :0])
            sa, sb = int(bounds[d]), int(bounds[d + 1])
            lo, hi = max(sa, win[r][0]), min(sb, win[r][1])
            recv.append(max(0, hi - lo) * lw)
        pieces = self.exchange(send, recv, x.dtype)
        parts = []
        for s in range(n):
            if s == r:
                parts.append(x)
            elif recv[s]:
                parts.append(pieces[s].reshape(lead + (recv[s] // lw,)))
        return torch.cat(parts, dim=-1), win[r][0]

    def all_gather_cols(self, x, bounds):
        """x [..., b - a] -> [..., T] the whole axis on every rank (one
        all-gather of blocks padded to the longest)."""
        self._count("all_gather")
        n = self.size
        T = int(bounds[-1])
        w = int(np.max(np.diff(bounds)))
        lead = x.shape[:-1]
        xp = torch.nn.functional.pad(x, (0, w - x.shape[-1]))
        out = torch.empty((n,) + lead + (w,), dtype=x.dtype, device=x.device)
        self._all_gather(_real(out).reshape(-1), _flat(xp))
        parts = [out[d][..., : int(bounds[d + 1] - bounds[d])]
                 for d in range(n)]
        full = torch.cat(parts, dim=-1)
        assert full.shape[-1] == T
        return full

    def gather_to(self, x, counts, dst: int):
        """x [..., c_r] -> on rank dst the pieces of every rank concatenated
        in rank order [..., sum(counts)]; None on the others.  counts[s]:
        the columns rank s sends (every rank passes the same list)."""
        r, n = self.rank, self.size
        lead = x.shape[:-1]
        lw = int(np.prod(lead)) if lead else 1
        send = [x if d == dst else x[..., :0] for d in range(n)]
        recv = [int(counts[s]) * lw if r == dst else 0 for s in range(n)]
        pieces = self.exchange(send, recv, x.dtype)
        if r != dst:
            return None
        return torch.cat([p.reshape(lead + (int(counts[s]),))
                          for s, p in enumerate(pieces)], dim=-1)

    def all_gather_object(self, obj):
        self._count("all_gather_object")
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj, src: int = 0):
        self._count("broadcast_object")
        box = [obj]
        if self.group is not None:  # src is a rank of the group
            src = dist.get_global_rank(self.group, src)
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    def barrier(self):
        dist.barrier(group=self.group)


def make_mesh(backend: str, init_method: str, rank: int, world_size: int,
              device=None) -> Mesh:
    """Join the process group (backend "nccl" or "gloo", chosen by the
    caller; an init failure raises) and return this rank's Mesh.  device
    defaults to cuda:<LOCAL_RANK or rank> under either backend; gloo ranks
    may share one CUDA device, or run on the CPU when the caller names
    "cpu".  A CUDA device without CUDA raises."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {device} asked for, but CUDA is "
                               f"not available (name device='cpu' to run "
                               f"the ranks on the CPU)")
        torch.cuda.set_device(device)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return Mesh(device)
