"""Run one function on n ranks of a mesh, each in its own spawned process.

    results = run_ranks(fn, n, init_file, backend="gloo", device=None,
                        timeout=120.0, args=())

Each rank joins the process group through a FileStore at `init_file` (a
path no other group uses; the file must not exist yet), makes its Mesh
(sharding.make_mesh; device None gives each rank cuda:<rank>, and
"cpu" the CPU) and returns fn(mesh, *args), which must be picklable,
as must fn itself (a module-level function).  run_ranks returns the ranks'
results in rank order.  It raises RuntimeError when a rank raises, dies or
does not finish within `timeout` seconds; every rank is then killed, so a
stalled collective cannot outlive the call.
"""

from __future__ import annotations

import queue
import time
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(fn, rank, n, init_file, backend, device, threads, args, out):
    import torch.distributed as dist

    from .sharding import make_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = make_mesh(backend, "file://" + init_file, rank, n,
                         device=device)
        res = fn(mesh, *args)
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, init_file: str, backend: str = "gloo",
              device=None, timeout: float = 120.0, args=(), threads: int = 1):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, init_file, backend, device, threads,
                               args, out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"run_ranks: {n - len(results)} of {n} ranks did not "
                    f"finish within {timeout} s" + "".join(errors))
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"run_ranks: rank(s) {dead} died "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})"
                                       + "".join(errors))
                continue
            if ok:
                results[rank] = res
            else:
                errors.append(f"\n--- rank {rank} ---\n{res}")
                # the other ranks may now wait in a collective forever
                raise RuntimeError("run_ranks: a rank failed" +
                                   "".join(errors))
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        out.close()
    return [results[r] for r in range(n)]
