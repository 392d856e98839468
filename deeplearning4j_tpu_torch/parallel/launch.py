"""Starting the ranks of a process group on one machine.

``spawn_ranks(fn, world_size, args, run_dir=...)`` starts one process
per rank with the ``spawn`` context (never ``fork``: a parent that has
initialised CUDA cannot fork a child that uses it), joins each to the
group through a ``FileStore`` in ``run_dir`` (no fixed TCP port), runs
``fn(rank, world_size, *args)`` there, and leaves the group. Every group
gets a collective ``timeout``; every ``join`` has a deadline, and a rank
that overruns it is killed and named in the ``TimeoutError`` raised. The
ranks' exit codes are returned for the caller to check (a watchdog run
expects ``PEER_LOSS_EXIT_CODE`` from a survivor).

``fn`` must be importable by name in a fresh interpreter (a module-level
function). Kernel libraries are built once by the parent before the
ranks start: a rank loads them from the build directory and never
compiles a source another rank is compiling.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.parallel.mesh import (initialize_distributed,
                                                    shutdown_distributed)


def _rank_main(fn, rank, world, backend, store_path, group_timeout_s,
               device, args):
    initialize_distributed(backend, rank, world, store_path=store_path,
                           timeout_s=group_timeout_s, device=device)
    try:
        fn(rank, world, *args)
    finally:
        shutdown_distributed()


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), *,
                run_dir: str, backend: str = "gloo",
                timeout_s: float = 300.0, group_timeout_s: float = 120.0,
                device: Optional[str] = None,
                name: str = "group") -> List[int]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one group; returns their exit codes in rank
    order. Raises ``TimeoutError`` naming the ranks still running after
    ``timeout_s`` (they are killed first)."""
    os.makedirs(run_dir, exist_ok=True)
    store = os.path.join(run_dir, f"{name}.store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"{name}-rank{r}",
                         args=(fn, r, world_size, backend, store,
                               group_timeout_s, device, tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    overran = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10.0)
    if overran:
        raise TimeoutError(f"{', '.join(overran)} still running after "
                           f"{timeout_s:.0f} s: killed")
    return [p.exitcode for p in procs]
