"""Start one process per rank of a `torch.distributed` mesh (`mesh.RankMesh`).

    results = run_ranks(fn, n, args=(...), device="cuda", backend="nccl")

runs `fn(mesh, *args)` in n new processes, rank r of an n-rank process
group each, and returns the n results in rank order.  `grid=(n0, n1)`
lays the ranks out on the two-axis mesh (`RankMesh(..., grid=...)`).
`fn` is a function at module level (the processes start from a fresh
import: the `spawn` method, the only one that is safe once the parent has
touched CUDA), and it returns host data (numpy arrays, Python values),
which travels back pickled through a queue.  `fn` and `args` go to the
ranks pickled in one
file, not through the start pipes: a start pipe that fills blocks the
parent until that child has imported everything, so the ranks would start
one after another.

- The ranks meet at a file store in a fresh temporary directory, so
  concurrent launches (test workers) never clash on a port.
- `timeout_s` is the process group's timeout: a collective that a
  neighbour never joins fails within it instead of hanging.  It counts
  from the moment every rank has started (the ranks first meet at the
  store, within START_TIMEOUT_S): a loaded host can start the ranks
  seconds apart.  `deadline_s` bounds the whole launch in the parent.
- `device` "cuda" puts rank r on card r mod the card count (all ranks on
  card 0 of a one-card machine, which needs backend "gloo"); a CPU rank
  runs one intra-op thread.
- An exception in any rank re-raises in the parent as `RankError` with the
  rank's traceback, and the other ranks are killed; so is a rank that
  exits without a result.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh
from mpm_flip98a_tpu_torch.state import from_host_bits, host_bits


# How long a rank waits at the store for the others to start.
START_TIMEOUT_S = 300.0


class RankError(RuntimeError):
    """A rank of `run_ranks` raised, or died without a result."""


def _rank_main(rank, n, work, device, backend, grid, store, timeout_s, results):
    try:
        with open(work, "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        meet = dist.FileStore(store, n)
        meet.set_timeout(timedelta(seconds=START_TIMEOUT_S))
        meet.set(f"started/{rank}", "1")
        meet.wait([f"started/{r}" for r in range(n)])
        dist.init_process_group(backend, store=meet, rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        out = (rank, True, fn(RankMesh(dev, backend, grid), *args))
    except BaseException:
        out = (rank, False, traceback.format_exc())
    results.put(out)
    # In the pipe before the group goes: a neighbour that loses its
    # connection then reports after this rank, not before.
    results.close()
    results.join_thread()
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, n: int, *, args=(), device="cuda", backend: str = "nccl",
              timeout_s: float = 60.0, deadline_s: float = None, grid=None) -> list:
    """`fn(mesh, *args)` on n ranks; their results in rank order."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mpm_ranks_") as tmp:
        work = os.path.join(tmp, "work.pkl")
        with open(work, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        results = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, n, work, str(device), backend, grid, os.path.join(tmp, "store"), timeout_s,
                results))
            for r in range(n)
        ]
        for p in procs:
            p.start()
        out, got = [None] * n, set()
        end = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            while len(got) < n:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_mod.Empty:
                    gone = [r for r, p in enumerate(procs) if r not in got and not p.is_alive()]
                    if gone:
                        try:    # a result written just before its rank exited
                            rank, ok, payload = results.get(timeout=2.0)
                        except queue_mod.Empty:
                            raise RankError(f"rank {gone[0]} exited with code "
                                            f"{procs[gone[0]].exitcode} and no result") from None
                    elif end is not None and time.monotonic() > end:
                        raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} "
                                           f"ran past {deadline_s} s") from None
                    else:
                        continue
                if not ok:
                    raise RankError(f"rank {rank} of {n} failed:\n{payload}")
                out[rank] = payload
                got.add(rank)
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(got) == n else 0.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return out


def mesh_calls(mesh: RankMesh, calls) -> list:
    """A `run_ranks` worker that calls RankMesh methods: for each (methods,
    blocks, kwargs), one of each per rank, this rank calls
    `mesh.<methods[rank]>(blocks[rank], **kwargs[rank])` and returns the
    results as numpy arrays, in order (bfloat16 blocks and results as
    `state.host_bits` records)."""
    out = []
    for methods, blocks, kwargs in calls:
        x = from_host_bits(blocks[mesh.rank], mesh.device)
        out.append(host_bits(getattr(mesh, methods[mesh.rank])(x, **kwargs[mesh.rank])))
    return out
