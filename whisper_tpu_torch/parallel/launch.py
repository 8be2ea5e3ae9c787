"""Start SPMD ranks from one process, and join them safely.

`spawn(fn, world_size, args)` starts `world_size` fresh interpreters
(`torch.multiprocessing.start_processes`, the "spawn" start method: no
state is inherited, so a rank imports only what `fn`'s module imports),
joins each to the process group (`mesh.init_process`), runs
`fn(rank, *args)` and returns every rank's return value in rank order. One
rank that fails fails the whole run: `ProcessContext.join` stops the
survivors, which would otherwise wait in a collective for their dead peer
until their own timeout, and re-raises that rank's traceback. A run that
outlasts `timeout_s` is killed the same way. `torchrun` starts ranks as
well; then each calls `mesh.init_process` itself, with
`init_method="env://"`.
"""

from __future__ import annotations

import os
import pickle
import queue
import time
from typing import Any, Callable, List, Optional, Sequence

from torch import multiprocessing as torch_mp


def _rank_main(rank, fn, world_size, init_method, backend, timeout_s,
               threads, args, results):
    import torch
    import torch.distributed as dist

    from .mesh import init_process

    if threads:
        torch.set_num_threads(threads)
    init_process(rank, world_size, init_method, backend, timeout_s)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    # pickled here, by value: the queue's own pickler would pass a tensor
    # as a shared-memory handle, gone once this process exits
    results.put((rank, pickle.dumps(out)))


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
          init_method: str, backend: Optional[str] = None,
          timeout_s: float = 120.0, threads: Optional[int] = None
          ) -> List[Any]:
    """Run `fn(rank, *args)` on `world_size` ranks; returns their results
    in rank order. `fn` and `args` must pickle (`fn` a module-level
    function), and so must the results. `init_method` names the
    rendezvous ("file:///path" keeps concurrent runs apart; the file must
    not exist yet); `backend` defaults as in `mesh.init_process`;
    `threads` sets each rank's `torch.set_num_threads`. Raises
    `torch.multiprocessing.ProcessRaisedException` (with the first failing
    rank's traceback) or `ProcessExitedException`, or TimeoutError, after
    every rank is stopped."""
    results = torch_mp.get_context("spawn").Queue()
    ctx = torch_mp.start_processes(
        _rank_main, args=(fn, world_size, init_method, backend, timeout_s,
                          threads, tuple(args), results),
        nprocs=world_size, join=False, start_method="spawn")
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        # a rank's put blocks until its result is read: drain while joining
        while not ctx.join(timeout=0.1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks did not all finish "
                                   f"within {timeout_s:.0f} s")
            try:
                rank, value = results.get(timeout=1.0)
                out[rank] = pickle.loads(value)
            except queue.Empty:
                pass
        while len(out) < world_size:  # every rank exited with code 0
            rank, value = results.get(timeout=10.0)
            out[rank] = pickle.loads(value)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [out[r] for r in range(world_size)]


def file_init_method(directory: str) -> str:
    """A "file://" init method under `directory` (which must exist), fresh
    for this run."""
    path = os.path.join(os.path.abspath(directory), "rendezvous")
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path
