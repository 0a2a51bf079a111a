"""The data-parallel group and the data-parallel step.

Port of streamingflow_tpu/parallel/mesh.py.  The JAX package runs one
jitted step over the global batch, sharded over a 1-D 'data' mesh, and XLA
inserts the collectives.  Here one process runs each rank (launched by
``torch.distributed.run``, which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``), ``BATCHSIZE`` stays the *global* batch, and every place
where samples meet is made global by hand, so that every rank ends the step
with the parameters, Adam state and running statistics of one process that
ran the global batch:

* batch statistics (layers/trainmode.py ``BatchNorm``,
  models/lidar_encoder.py ``MaskedBatchNorm``): per-channel sums and counts
  all-reduced;
* loss denominators (training/losses.py ``spatial_regression_loss``): the
  valid count all-reduced;
* random draws (``Dropout``, the GRU-ODE's noise): drawn at the global
  batch's shape from a generator every rank holds in the same state, each
  rank keeping its rows;
* gradients: averaged with one all-reduce over a flat buffer after
  ``backward()`` (parallel/collect.py), then the global norm is clipped and
  Adam steps, the JAX step's order.  Not ``DistributedDataParallel``: the
  step gives parameters that the loss does not reach a zero gradient (which
  DDP's unused-parameter check rejects), the recompute of ``MODEL.REMAT``
  runs its BatchNorm all-reduces inside ``backward()``, where DDP's bucket
  hooks would interleave with them, and one all-reduce after the backward is
  the JAX package's psum, in the same place.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass
class DataGroup:
    """This rank's place in the data-parallel run: ``rank`` of ``world``
    ranks that take part, ``pg`` their process group (None at world 1),
    ``device`` the rank's device.  ``active`` is False on a rank that takes
    no step (the global batch does not shard over it)."""
    rank: int
    world: int
    pg: Optional[dist.ProcessGroup]
    device: torch.device
    active: bool = True

    @property
    def is_main(self) -> bool:
        """The rank that writes checkpoints and logs."""
        return self.active and self.rank == 0


def participants(batch_size: int, world: int) -> int:
    """The largest rank count up to ``world`` that divides the global
    batch (batch 1 on two ranks trains on one), make_mesh's rule in the
    JAX package."""
    n = world
    while batch_size % n:
        n -= 1
    return n


def launcher_env() -> Dict[str, int]:
    """RANK, WORLD_SIZE and LOCAL_RANK as the launcher set them (world 1
    without a launcher)."""
    return {k: int(os.environ.get(k, d)) for k, d in
            (('RANK', 0), ('WORLD_SIZE', 1), ('LOCAL_RANK', 0))}


def rank_device(device=None, local_rank: Optional[int] = None
                ) -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK % device_count}`` (two ranks
    share a one-card machine) unless asked for the CPU or a given card;
    raises when CUDA is absent and no CPU was asked for."""
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        if local_rank is None:
            local_rank = launcher_env()['LOCAL_RANK']
        dev = torch.device('cuda', local_rank % torch.cuda.device_count())
    return dev


def init_distributed(device=None, backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the launcher's process group (``env://``) when ``WORLD_SIZE``
    is set: NCCL on the card, gloo on the CPU, unless ``backend`` says
    which.  Returns the rank's device.  A rank that cannot join raises."""
    env = launcher_env()
    dev = rank_device(device, env['LOCAL_RANK'])
    if 'WORLD_SIZE' in os.environ and not dist.is_initialized():
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or ('nccl' if dev.type == 'cuda' else 'gloo'),
            init_method='env://', rank=env['RANK'],
            world_size=env['WORLD_SIZE'],
            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(batch_size: int, device=None) -> DataGroup:
    """The data-parallel group of this rank for a global batch of
    ``batch_size``.  Without an initialised process group: world 1, no
    group.  Otherwise the first :func:`participants` ranks take part (a
    subgroup when not all do; every rank must call this, as
    ``new_group`` is collective)."""
    if not dist.is_initialized():
        return DataGroup(0, 1, None, rank_device(device))
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = rank_device(device, launcher_env()['LOCAL_RANK'])
    n = participants(batch_size, world)
    pg = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return DataGroup(rank if rank < n else -1, n, pg if rank < n else None,
                     dev, rank < n)


def shard_batch(batch, group: DataGroup):
    """Rank r's rows ``[r b, (r + 1) b)`` of a global batch dict (numpy
    arrays, tensors or lists, batch-major), b = rows / world."""
    def rows(v):
        n = len(v)
        if n % group.world:
            raise ValueError(f'a global batch of {n} does not shard over '
                             f'{group.world} ranks')
        b = n // group.world
        return v[group.rank * b:(group.rank + 1) * b]
    return {k: rows(v) if isinstance(v, (np.ndarray, torch.Tensor, list))
            else v for k, v in batch.items()}


def complete_batches(loader, group: DataGroup
                     ) -> Iterator[Optional[dict]]:
    """The loader's training batches, in step with every rank of
    ``group``: this rank's batch of each global batch, or None on every
    rank where some rank does not hold all its rows.  The loader drops an
    item the dataset marks invalid (data/dataloader.py); a step on the
    shorter shard would no longer be the one-process step (the ranks'
    totals, loss scales and draws disagree), and a rank left with no batch
    would leave the others waiting in a collective, so the ranks agree on
    each global batch (one all-reduce) and all skip it.  World 1: the
    loader's batches as they come."""
    if group.world == 1:
        yield from loader
        return
    from .collect import _all_reduce, comm_device
    per = loader.sampler.batch_size // group.world
    for batch in loader.rank_batches():
        short = torch.tensor(
            [batch is None or len(batch['future_egomotion']) != per],
            dtype=torch.int32, device=comm_device(group))
        _all_reduce(short, pg=group.pg)
        yield None if int(short) else batch


def make_data_parallel_step(cfg, group: DataGroup):
    """The step over a global batch of ``cfg.BATCHSIZE``: this rank's rows
    (:func:`shard_batch`) through ``train_step`` of a trainer built with
    ``group`` (``build_trainer(cfg, group=group)``), which makes every
    coupling of samples global.  ``step(trainer, batch, generator)``;
    ``generator`` in the same state on every rank."""
    from ..training.trainer import train_step

    def step(trainer, batch, generator: Optional[torch.Generator] = None):
        if trainer.group is not group:
            raise ValueError('the trainer was not built with this group')
        rows = len(batch['future_egomotion'])
        if rows != cfg.BATCHSIZE:
            raise ValueError(f'a global batch of {rows} rows, BATCHSIZE '
                             f'{cfg.BATCHSIZE}')
        return train_step(trainer, shard_batch(batch, group), generator)

    return step
