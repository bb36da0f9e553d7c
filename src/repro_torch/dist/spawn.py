"""Run a function on W ranks of one host, each a spawned process in one
``torch.distributed`` world, with a hard timeout.

``run_ranks(fn, world, *args)`` starts W processes with the ``spawn``
start method (the parent may already hold CUDA state), joins them into a
process group through a ``file://`` rendezvous in a fresh directory (so
concurrent callers never collide), calls ``fn(rank, *args)`` in each and
returns the W results in rank order. ``fn`` must be importable by name and
its results picklable. If a rank raises, the others are stopped and the
rank's traceback is raised; if the ranks outlive ``timeout`` seconds (a
hung collective, say), all are stopped and ``TimeoutError`` is raised.
Nothing is left running either way.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(fn, rank, world, init, backend, args, out):
    import torch
    import torch.distributed as dist
    try:
        # one intra-op thread: ranks share the host's cores
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
        res = fn(rank, *args)
        dist.barrier()
        out.put((rank, True, res))
    except BaseException:
        # the parent raises the traceback and stops the other ranks
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str = "gloo",
              timeout: float = 300.0, tmpdir=None):
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own rank
    of a ``backend`` group of ``world`` spawned processes."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="rdv-", dir=tmpdir)
    init = "file://" + os.path.join(rdv, "init")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init, backend, args, out))
             for r in range(world)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world} ranks of {fn.__name__} ran past {timeout} s")
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {fn.__name__} "
                                       f"died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{res}")
            results[rank] = res
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rdv, ignore_errors=True)
    return [results[r] for r in range(world)]
