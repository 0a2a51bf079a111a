"""Checkpoints and resume (port of streamingflow_tpu/training/checkpoint.py).

Reference behaviour: Lightning ModelCheckpoint(save_top_k=-1, period=1),
every epoch kept, with the hyperparameters beside the weights so that a
checkpoint alone rebuilds model and cfg (reference train.py:67-72,
evaluate.py:33), and auto-resume from the highest step (train.py:15-41).

Layout of a checkpoint directory::

    config.json              cfg.to_dict() of the run, as the JAX package
    <step>/checkpoint.pt     torch.save of {'format', 'step',
                             'optimizer_step', 'model', 'optimizer',
                             'generator'}

``step`` is the directory's label (``train`` labels a checkpoint with the
epochs done), ``optimizer_step`` the trainer's count of optimizer steps.
``model`` is the train module's state_dict (parameters and BatchNorm
buffers), ``optimizer`` Adam's state_dict (``optimizer`` and
``optimizer_step`` are None in a checkpoint converted from JAX weights,
convert.save_flax_variables_as_checkpoint), ``generator``
the state of the run's explicit torch.Generator (or None).  All tensors are
on the CPU, and each file loads with ``torch.load(weights_only=True)``.  A
step is written under a temporary name and renamed into place, so a run cut
while saving leaves the steps before it, never a half-written one.  The JAX
package's orbax steps sit in the same ``<step>`` directories without a
``checkpoint.pt``: the manager raises on them and names the conversion.

In a data-parallel run (a ``group`` from parallel.make_mesh) rank 0 alone
writes, and every rank waits at a barrier after the save; a restore reads
on rank 0 and broadcasts the state to the other ranks.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from ..config import Config
from ..parallel.collect import barrier, broadcast_object

FORMAT = 'streamingflow_tpu_torch'
FILENAME = 'checkpoint.pt'


class ForeignCheckpointError(RuntimeError):
    """A step directory that the port did not write (an orbax step)."""


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Epoch-per-checkpoint manager that keeps the config beside the
    weights."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # ----------------------------------------------------------------- steps
    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not (name.isdigit() and os.path.isdir(path)):
                continue
            if not os.path.exists(os.path.join(path, FILENAME)):
                raise ForeignCheckpointError(
                    f'{path} holds no {FILENAME}: a checkpoint of the JAX '
                    f'package (orbax)?  Convert it with streamingflow_tpu_'
                    f'torch.convert.save_flax_variables_as_checkpoint '
                    f'(see README); the port does not start from random '
                    f'weights in its place')
            steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _path(self, step: Optional[int]) -> str:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoint in {self.directory}')
        return os.path.join(self.directory, str(step), FILENAME)

    # ------------------------------------------------------------------ save
    def write(self, step: int, state: Dict, cfg: Config) -> str:
        """Write a raw checkpoint dict (``model``, ``optimizer``,
        ``optimizer_step``, ``generator``) for ``step``, and
        ``config.json``; returns the file's path."""
        cfg_tmp = os.path.join(self.directory, f'.config.json.{os.getpid()}')
        with open(cfg_tmp, 'w') as f:
            json.dump(cfg.to_dict(), f, indent=2, default=str)
        os.replace(cfg_tmp, os.path.join(self.directory, 'config.json'))

        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f'.{step}.tmp.{os.getpid()}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        optimizer_step = state.get('optimizer_step')
        payload = {'format': FORMAT, 'step': int(step),
                   'optimizer_step': (None if optimizer_step is None
                                      else int(optimizer_step)),
                   'model': _cpu(state['model']),
                   'optimizer': _cpu(state.get('optimizer')),
                   'generator': _cpu(state.get('generator'))}
        with open(os.path.join(tmp, FILENAME), 'wb') as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return os.path.join(final, FILENAME)

    def save(self, step: int, trainer, cfg: Config,
             generator: Optional[torch.Generator] = None) -> str:
        """Save the trainer's module and Adam state (and ``generator``'s
        state) as ``step``: on rank 0 of the trainer's group, every rank
        waiting until it is written.  Returns the file's path."""
        group = trainer.group
        if group is None or group.is_main:
            self.write(step, {
                'model': trainer.module.state_dict(),
                'optimizer': trainer.optimizer.state_dict(),
                'optimizer_step': trainer.step,
                'generator': (generator.get_state() if generator is not None
                              else None)}, cfg)
        barrier(group)
        return self._path(step)

    # --------------------------------------------------------------- restore
    def restore_raw(self, step: Optional[int] = None) -> Dict:
        """The checkpoint dict of ``step`` (default: the latest), on the
        CPU."""
        raw = torch.load(self._path(step), map_location='cpu',
                         weights_only=True)
        if raw.get('format') != FORMAT:
            raise ForeignCheckpointError(f'{self._path(step)}: not a '
                                         f'{FORMAT} checkpoint')
        return raw

    def restore(self, trainer, step: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        """Load ``step`` (default: the latest) into the trainer in place:
        the module strictly, Adam's state and the count of optimizer steps
        where the checkpoint has them, and ``generator``'s state.  In a
        data-parallel group rank 0 reads and every rank loads its state.
        Returns the trainer."""
        group = trainer.group
        raw = broadcast_object(
            self.restore_raw(step) if group is None or group.is_main
            else None, group)
        trainer.module.load_state_dict(raw['model'], strict=True)
        if raw['optimizer'] is not None:
            trainer.optimizer.load_state_dict(raw['optimizer'])
        if raw['optimizer_step'] is not None:
            trainer.step = raw['optimizer_step']
        if generator is not None and raw['generator'] is not None:
            generator.set_state(raw['generator'])
        return trainer

    def load_cfg(self) -> Config:
        with open(os.path.join(self.directory, 'config.json')) as f:
            return Config().merge_dict(json.load(f))


def warm_start(trainer, pretrained_dir: str, drop: str = 'decoder'
               ) -> Tuple[object, int]:
    """Partial load of a (possibly single-frame) pretrained checkpoint,
    dropping every tensor whose name contains ``drop`` (reference
    train.py:50-58: 'remove decoder weights, strict=False').  Only tensors
    that exist in the trainer's module with identical shapes are copied.
    Returns (trainer, number of tensors loaded)."""
    src = CheckpointManager(pretrained_dir).restore_raw()['model']
    dst = trainer.module.state_dict()
    n = 0
    with torch.no_grad():
        for name, value in src.items():
            if drop in name or name not in dst or \
                    name.endswith('num_batches_tracked'):
                continue
            if tuple(value.shape) != tuple(dst[name].shape):
                continue
            dst[name].copy_(value)
            n += 1
    return trainer, n


def get_latest_checkpoint_dir(log_dir: str) -> Optional[str]:
    """The most recent run directory under ``log_dir`` that holds
    checkpoints (reference train.py:15-41 auto-resume)."""
    if not os.path.isdir(log_dir):
        return None
    candidates = []
    for name in os.listdir(log_dir):
        ckpt_dir = os.path.join(log_dir, name, 'checkpoints')
        if os.path.isdir(ckpt_dir):
            candidates.append((os.path.getmtime(ckpt_dir), ckpt_dir))
    if not candidates:
        return None
    return max(candidates)[1]
