"""Dataset -> batches (port of streamingflow_tpu/data/dataloader.py;
reference datas/dataloaders.py:10-74).

Items are built by ``torch.utils.data.DataLoader`` workers
(``num_workers = cfg.N_WORKERS``, kept across epochs) and come out
as dicts of CPU tensors (pinned when the batches go to a CUDA device), in
the JAX loader's order: batch b of epoch e holds the indices of
``np.random.RandomState(seed + e)``'s shuffle (or the natural order), cut
into ``batch_size`` pieces, the last partial one dropped with ``drop_last``.
Items whose ``status`` is not 'valid' are dropped from their batch, and an
emptied batch is skipped, as there.

``DataLoader.close`` stops a loader's workers; :func:`stop_worker_server`
then stops the server process they were forked from and its resource
tracker, so that a program that must leave no process behind can.
"""
from __future__ import annotations

import multiprocessing
from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.utils.data as tud

from ..config import Config


def worker_context():
    """The workers' start method: forked from a fresh server process that
    has imported the data path once (``forkserver``), never from the
    training process itself, whose threads and CUDA context a fork would
    copy.  A spawned worker would import torch (and CUDA's libraries)
    anew: 8 of them held the first batch back by 45 s on an H100 host."""
    ctx = multiprocessing.get_context('forkserver')
    ctx.set_forkserver_preload(['streamingflow_tpu_torch.data.nuscenes',
                                'streamingflow_tpu_torch.data.lyft'])
    return ctx


def stop_worker_server() -> None:
    """Stop the processes that :func:`worker_context` started: the fork
    server and the resource tracker, each waited for.  Close every loader
    with workers first.  A later loader with workers starts them again."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def collate(items):
    """Stack a list of per-sample dicts into a batch dict: arrays and
    numbers as CPU tensors, anything else as a list."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = torch.from_numpy(np.stack(vals))
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = torch.from_numpy(np.asarray(vals))
        else:
            out[key] = vals
    return out


def collate_valid(items) -> Optional[dict]:
    """:func:`collate` of the valid items; None when none is valid."""
    items = [it for it in items if it.get('status', 'valid') == 'valid']
    return collate(items) if items else None


class EpochBatchSampler(tud.Sampler):
    """Index batches of the JAX loader for the epoch in ``self.epoch``."""

    def __init__(self, n: int, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        for b in range(len(self)):
            yield [int(i) for i in
                   idx[b * self.batch_size:(b + 1) * self.batch_size]]


class DataLoader:
    """Shuffling, batching loader over worker processes; the epoch counts
    up after each full pass, as the JAX loader's does."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 0,
                 pin_memory: bool = False, seed: int = 0):
        self.dataset = dataset
        self.sampler = EpochBatchSampler(len(dataset), batch_size, shuffle,
                                         drop_last, seed)
        self.epoch = 0
        workers = dict(num_workers=num_workers,
                       multiprocessing_context=worker_context(),
                       persistent_workers=True) if num_workers > 0 else {}
        self._loader = tud.DataLoader(dataset, batch_sampler=self.sampler,
                                      collate_fn=collate_valid,
                                      pin_memory=pin_memory, **workers)

    def __len__(self):
        return len(self.sampler)

    def close(self) -> None:
        """Shut the workers down and wait for them; the next epoch starts
        new ones."""
        workers = self._loader._iterator
        self._loader._iterator = None
        if workers is not None and hasattr(workers, '_shutdown_workers'):
            workers._shutdown_workers()

    def __iter__(self) -> Iterator[dict]:
        self.sampler.epoch = self.epoch
        for batch in self._loader:
            if batch is not None:
                yield batch
        self.epoch += 1


def prepare_dataloaders(cfg: Config, return_dataset: bool = False,
                        pin_memory: bool = False):
    """Build train/val loaders (reference datas/dataloaders.py:10-74).
    ``pin_memory``: page-locked batches, for a CUDA device."""
    from .nuscenes import FuturePredictionDataset
    from .nuscenes_sdk import NuScenes

    version = cfg.DATASET.VERSION
    if cfg.DATASET.NAME == 'nuscenes':
        full_version = ('v1.0-mini' if version == 'mini'
                        else f'v1.0-{version}')
        nusc = NuScenes(version=full_version, dataroot=cfg.DATASET.DATAROOT)
        train_ds = FuturePredictionDataset(nusc, 0, cfg)
        val_ds = FuturePredictionDataset(nusc, 1, cfg)
    elif cfg.DATASET.NAME == 'lyft':
        # Lyft L5 ships in the nuScenes table schema; same reader, Lyft
        # split/category semantics (data/lyft.py)
        from .lyft import FuturePredictionDatasetLyft
        nusc = NuScenes(version=version, dataroot=cfg.DATASET.DATAROOT)
        train_ds = FuturePredictionDatasetLyft(nusc, 0, cfg)
        val_ds = FuturePredictionDatasetLyft(nusc, 1, cfg)
    else:
        raise ValueError(f'unknown dataset {cfg.DATASET.NAME}')

    if version == 'mini':
        # reference truncates the mini split (dataloaders.py:18-21)
        train_ds.indices = train_ds.indices[:10]
        val_ds.indices = val_ds.indices[:10]

    kw = dict(num_workers=cfg.N_WORKERS, pin_memory=pin_memory)
    train = DataLoader(train_ds, cfg.BATCHSIZE, shuffle=True, **kw)
    val = DataLoader(val_ds, cfg.BATCHSIZE, shuffle=False, drop_last=False,
                     **kw)
    if return_dataset:
        return train, val, train_ds, val_ds
    return train, val
