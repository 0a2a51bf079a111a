"""Weights of the JAX package -> the port's state_dict, and back.

The port's submodules carry the flax variable paths as names, so each torch
tensor ``a.b.Conv_0.weight`` has one flax leaf ``a/b/Conv_0/kernel`` and the
layout changes by rule:

  Conv2d / depthwise  kernel (kH, kW, I/g, O)      -> weight (O, I/g, kH, kW)
  Conv3d              kernel (kT, kH, kW, I, O)    -> weight (O, I, kT, kH, kW)
  Linear              kernel (I, O)                -> weight (O, I)
  BatchNorm           params scale / bias          -> weight / bias
                      batch_stats mean / var       -> running_mean / running_var
  LayerNorm           scale / bias                 -> weight / bias
  raw parameters      *_kernel (3, 3, I, O)        -> (O, I, 3, 3) (GRUGates'
                      fused gates kernel stays fused); others as they are
  sparse LiDAR ladder kernel / kernel1 / kernel2   -> as they are, (taps, I, O)
                      (modules with ``JAX_LAYOUT = True``); MaskedBatchNorm
                      is a BatchNorm

Variables come as numpy arrays: ``{'params': {...}, 'batch_stats': {...}}``
nested dicts.  The conversion raises if a JAX leaf is left unconsumed or a
torch parameter or buffer is left unassigned (BatchNorm's
``num_batches_tracked`` is torch's own training counter and is set to 0).
One exception: the distribution head ``present_distribution``
(PROBABILISTIC.ENABLED).  No forward calls it, in the JAX package as in the
reference, so a JAX tree made by ``init`` holds none of its leaves; when the
tree has no leaf of it at all, its tensors keep the module's own values (as
the rule table's IGNORED_FLAX treats them).  A tree with some of its leaves
is held to all of them.
BatchNorm eps is a constructor argument of each torch module and matches the
flax module's (1e-3 in EfficientNet and the pillar ladder, 1e-5 elsewhere);
flax BN momentum m is torch momentum 1 - m.

The train module (training/trainer.py::StreamingFlowTrainModule) maps by the
same rules: ``params/model/...``, ``params/task_weights/{name}_weight`` and
``batch_stats/model/...``.  :func:`state_to_flax` is the way back: a
module's parameters, gradients and BatchNorm statistics as numpy trees under
the flax names and layouts, to compare leaf by leaf.

:func:`save_flax_variables_as_checkpoint` carries a JAX training run's
weights into a port checkpoint (training/checkpoint.py) that the port's
``evaluate`` and ``PRETRAINED`` warm start load.  With both packages
installed::

    from streamingflow_tpu.training.checkpoint import CheckpointManager
    ckpt = CheckpointManager('LOG_DIR/TAG/checkpoints')   # orbax, JAX side
    raw, cfg = ckpt.restore_raw(), ckpt.load_cfg()
    from streamingflow_tpu_torch.config import Config
    from streamingflow_tpu_torch.convert import \
        save_flax_variables_as_checkpoint
    save_flax_variables_as_checkpoint(
        raw, Config().merge_dict(cfg.to_dict()), 'port_ckpt',
        ckpt.latest_step())
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


# the module that a JAX tree may lack whole (see the docstring)
HEAD = 'present_distribution'


def flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    """flax (spatial..., I, O) -> torch (O, I, spatial...)."""
    nd = k.ndim
    return np.transpose(k, (nd - 1, nd - 2, *range(nd - 2)))


def _kernel_to_flax(w: np.ndarray) -> np.ndarray:
    """torch (O, I, spatial...) -> flax (spatial..., I, O)."""
    return np.transpose(w, (*range(2, w.ndim), 1, 0))


# the way back of each transform of :func:`_leaf_rule`
_INVERSE = {None: None, np.transpose: np.transpose,
            _kernel_to_torch: _kernel_to_flax}


def _leaf_rule(module: nn.Module, name: str):
    """(collection, flax leaf name, transform) for torch tensor ``name``."""
    if isinstance(module, (nn.Conv2d, nn.Conv3d)):
        return {'weight': ('params', 'kernel', _kernel_to_torch),
                'bias': ('params', 'bias', None)}[name]
    if isinstance(module, nn.Linear):
        return {'weight': ('params', 'kernel', np.transpose),
                'bias': ('params', 'bias', None)}[name]
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return {'weight': ('params', 'scale', None),
                'bias': ('params', 'bias', None),
                'running_mean': ('batch_stats', 'mean', None),
                'running_var': ('batch_stats', 'var', None)}[name]
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return {'weight': ('params', 'scale', None),
                'bias': ('params', 'bias', None)}[name]
    if getattr(module, 'JAX_LAYOUT', False):
        return 'params', name, None
    if name.endswith('kernel'):
        return 'params', name, _kernel_to_torch
    return 'params', name, None


def flax_to_state_dict(model: nn.Module, variables: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """Map a JAX variable tree onto ``model``'s state_dict (CPU tensors in
    each target's dtype).  Raises on any unconsumed or missing leaf, or a
    shape mismatch."""
    leaves = {col: flatten(variables.get(col, {}))
              for col in ('params', 'batch_stats')}
    extra = set(variables) - set(leaves)
    if extra:
        raise KeyError(f'unknown variable collections: {sorted(extra)}')
    used = {col: set() for col in leaves}
    target = model.state_dict()
    head_in_tree = any(HEAD in p.split('/') for col in leaves
                       for p in leaves[col])
    out, missing = {}, []
    for mod_name, module in model.named_modules():
        tensors = list(module.named_parameters(recurse=False)) + \
            list(module.named_buffers(recurse=False))
        for name, tensor in tensors:
            if tensor is None:
                continue
            full = f'{mod_name}.{name}' if mod_name else name
            if name == 'num_batches_tracked':
                out[full] = torch.zeros_like(tensor, device='cpu')
                continue
            col, leaf, fn = _leaf_rule(module, name)
            path = '/'.join([*mod_name.split('.'), leaf]) if mod_name \
                else leaf
            if path not in leaves[col]:
                if not head_in_tree and HEAD in mod_name.split('.'):
                    out[full] = target[full].detach().to('cpu', copy=True)
                else:
                    missing.append(f'{col}:{path} (for {full})')
                continue
            value = leaves[col][path]
            used[col].add(path)
            if fn is not None:
                value = fn(value)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f'{col}:{path} has shape {value.shape}, '
                                 f'{full} needs {tuple(tensor.shape)}')
            out[full] = torch.from_numpy(np.array(value)).to(
                target[full].dtype)
    unused = [f'{col}:{p}' for col in leaves
              for p in sorted(set(leaves[col]) - used[col])]
    if missing or unused:
        raise KeyError('JAX -> torch conversion incomplete:\n'
                       + ''.join(f'  torch tensor without a JAX leaf: {m}\n'
                                 for m in missing)
                       + ''.join(f'  JAX leaf not consumed: {u}\n'
                                 for u in unused))
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a JAX variable tree into ``model`` in place (strict)."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model


def state_to_flax(model: nn.Module, grads: bool = False
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """``model``'s tensors as flat numpy trees under the flax paths and
    layouts: ``{'params': {'a/b/kernel': ...}, 'batch_stats': {...}}``
    (compare with :func:`flatten` of a JAX tree).  ``grads``: the
    parameters' gradients in place of their values (a parameter without a
    gradient gives zeros) and no batch statistics."""
    out = {'params': {}, 'batch_stats': {}}
    for mod_name, module in model.named_modules():
        tensors = list(module.named_parameters(recurse=False))
        if not grads:
            tensors += list(module.named_buffers(recurse=False))
        for name, tensor in tensors:
            if tensor is None or name == 'num_batches_tracked':
                continue
            col, leaf, fn = _leaf_rule(module, name)
            if grads:
                tensor = (torch.zeros_like(tensor) if tensor.grad is None
                          else tensor.grad)
            # a copy: the tree must not follow later updates of the tensor
            value = np.array(tensor.detach().float().cpu().numpy())
            back = _INVERSE[fn]
            path = '/'.join([*mod_name.split('.'), leaf]) if mod_name \
                else leaf
            out[col][path] = value if back is None else back(value)
    return out


def save_flax_variables_as_checkpoint(variables: Mapping, cfg, directory: str,
                                      step: int) -> str:
    """Write the JAX train state's weights (``variables``: the numpy tree
    of the JAX ``CheckpointManager(...).restore_raw()``, or any mapping
    with ``params`` and ``batch_stats``) as step ``step`` of a port
    checkpoint directory, with ``cfg`` (a port Config) beside it.  Adam's
    state is not carried across: such a checkpoint is for evaluation or a
    warm start.  Returns the checkpoint file's path."""
    from .training.checkpoint import CheckpointManager
    from .training.trainer import StreamingFlowTrainModule
    module = StreamingFlowTrainModule(cfg)
    state = flax_to_state_dict(module, {
        'params': variables['params'],
        'batch_stats': variables.get('batch_stats', {})})
    return CheckpointManager(directory).write(
        step, {'model': state, 'optimizer': None, 'optimizer_step': None,
               'generator': None}, cfg)
