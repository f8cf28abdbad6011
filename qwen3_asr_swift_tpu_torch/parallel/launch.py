"""Start one process per rank, each joined to one process group.

    results = spawn(work, 4, args=(cfg,), device="cpu")   # work(rank, cfg)

``work`` must be a module-level function (it is pickled by reference).
Each rank sets one intra-op thread on the CPU (``threads``), joins the
group through a file store in a private temporary directory, selects its
card on the GPU (``rank % device_count``: several ranks share a card when
there are fewer cards than ranks) and returns ``work``'s result to the
parent, which gets the results in rank order.

A rank that raises, a rank that dies without a result, and a run that
outlasts ``timeout`` all end every rank and raise here: a collective that
one rank skips would otherwise hang the others.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Optional


def _rank_main(job, rank, world, init_method, backend, device, threads, results):
    try:
        work, args = pickle.loads(job)
        import torch
        import torch.distributed as dist

        from .mesh import init_distributed

        if threads:
            torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        init_distributed(backend=backend, init_method=init_method, world_size=world,
                         rank=rank, device=device)
        try:
            out = work(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))   # the parent raises it too
        raise


def spawn(work: Callable, world_size: int, args=(), *, device="cuda",
          backend: Optional[str] = None, timeout: float = 600.0,
          threads: Optional[int] = 1) -> List[object]:
    """Run ``work(rank, *args)`` on ``world_size`` new processes in one
    process group and return their results in rank order. ``backend``
    defaults to gloo on the CPU and NCCL on the card (pass ``"gloo"`` to
    put several ranks on one card)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # plain pickles both ways: a tensor then travels by value, not as a
    # shared-memory handle that dies with the process that made it
    job = pickle.dumps((work, tuple(args)))
    with tempfile.TemporaryDirectory(prefix="qs_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(job, r, world_size, init_method, backend, str(device),
                                   threads, results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                except queue_mod.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"spawn: {world_size - len(got)} of {world_size} "
                                           f"ranks gave no result within {timeout:g} s")
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive() and p.exitcode is not None]
                    if dead and results.empty():
                        time.sleep(0.5)   # a result may still be in the pipe
                        if results.empty():
                            raise RuntimeError(f"spawn: rank(s) {dead} exited (codes "
                                               f"{[procs[r].exitcode for r in dead]}) "
                                               "without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} raised:\n{out}")
                got[rank] = pickle.loads(out)
        finally:
            for p in procs:
                p.join(timeout=10 if len(got) == world_size else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]
