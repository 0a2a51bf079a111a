"""Run a function on n ranks in fresh processes on this host.

``torch.distributed.run`` is the launcher of a training run; this is the
small in-program one the dry run (tools/dryrun_multichip.py) and the card's
smoke test use: ``torch.multiprocessing`` ``spawn`` processes (never
``fork``: the caller may hold threads and a CUDA context), which kill the
other ranks when one fails; a ``FileStore`` rendezvous in a temporary
directory (no port to collide on); a timeout on the group's collectives and
on the join; and each rank's return value sent back through a file.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               directory: str, timeout_s: float, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(directory, 'store'),
                                      world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(directory, f'result.{rank}'))


def _rank_errors(ctx) -> str:
    """Every failed rank's traceback, or exit code.  The rank that join
    sees fail first need not be the cause: a peer waiting for it in a
    collective fails as soon as it goes."""
    out = []
    for r, (p, path) in enumerate(zip(ctx.processes, ctx.error_files)):
        if os.access(path, os.R_OK):
            with open(path, 'rb') as f:
                out.append(f'-- rank {r}:\n{pickle.load(f)}')
            os.unlink(path)
        elif p.exitcode:
            out.append(f'-- rank {r}: exit code {p.exitcode}\n')
    return 'ranks failed:\n' + ''.join(out)


def spawn_ranks(fn: Callable, world: int, *args, backend: str = 'gloo',
                timeout_s: float = 300.0) -> List:
    """``fn(*args)`` on ``world`` ranks of one process group (``backend``),
    each in a spawned process with ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` set; returns the ranks' results in rank order.  ``fn``
    is a module-level function (it is pickled by name) and builds its
    group with ``parallel.make_mesh``.  Raises RuntimeError with every
    failed rank's traceback at the first failure (the others killed), or
    TimeoutError, every rank killed, when the run outlasts
    ``timeout_s``."""
    with tempfile.TemporaryDirectory(prefix='sf_ranks_') as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, tmp, timeout_s, args),
            nprocs=world, join=False, daemon=True, start_method='spawn')
        deadline = time.monotonic() + timeout_s
        try:
            # join returns False while ranks run, and raises at the first
            # failure (a failed rank leaves the others in a collective)
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0),
                               grace_period=5.0):
                if time.monotonic() >= deadline:
                    late = [r for r, p in enumerate(ctx.processes)
                            if p.is_alive()]
                    raise TimeoutError(f'ranks {late} still running after '
                                       f'{timeout_s} s')
        except ProcessException as e:
            raise RuntimeError(_rank_errors(ctx)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f'result.{r}'),
                           weights_only=False) for r in range(world)]
