"""Collectives of the data-parallel step, and metric and result collection.

Port of streamingflow_tpu/parallel/collect.py.  The JAX package's metric
reductions (the reference's Lightning states with ``dist_reduce_fx='sum'``,
streamingflow/metrics.py:32-35, 89-92, and its rank-gather of eval results,
mmdet3d/models/beverse/tools/multi_gpu_test.py:212-287) become
``torch.distributed`` collectives over a :class:`~.mesh.DataGroup`:
:func:`psum_metric_states`, :func:`sum_across_processes`,
:func:`gather_across_processes`; :func:`combine_metrics` stays host-only.  A
world of one is the identity, as in JAX.

Beside them, the collectives the step itself runs, where XLA inserts them in
the JAX package: :func:`all_reduce_sum` (differentiable: the batch
statistics of a sharded BatchNorm), :func:`average_gradients` (one
all-reduce over a flat buffer after ``backward()``), :func:`reduce_metrics`
(the step's losses and ``diag/*`` counters to their global values).

Gloo reduces CUDA tensors but cannot all-gather them, and NCCL takes CUDA
tensors only, so the host-side collections move their arrays to the device
the group's backend takes (:func:`comm_device`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# collectives the step has run in this process (the batch statistics'
# all-reduces forward and backward, the gradient all-reduce, the metric
# reductions), read by the card's smoke test
collectives = 0


def _all_reduce(t, op=dist.ReduceOp.SUM, pg=None) -> None:
    global collectives
    collectives += 1
    dist.all_reduce(t, op=op, group=pg)


def _world(group) -> int:
    """The ranks of a DataGroup that collect (1: no collective)."""
    return 1 if group is None or group.world == 1 else group.world


def comm_device(group) -> torch.device:
    """The device the group's backend reduces and gathers on: this rank's
    card for NCCL, the CPU for gloo."""
    if dist.get_backend(group.pg) == 'nccl':
        return group.device
    return torch.device('cpu')


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``pg``; the cotangent is summed the same way
    (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = x.clone()
        _all_reduce(out, pg=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, pg=ctx.pg)
        return g, None


def all_reduce_sum(x: torch.Tensor, pg) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of the process group
    ``pg``."""
    return _AllReduceSum.apply(x, pg)


def _flat_by_dtype(tensors: Sequence[torch.Tensor]):
    """{dtype: (flat buffer, the tensors)}, each buffer the tensors of one
    dtype back to back."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return {dt: (torch.cat([t.reshape(-1) for t in ts]), ts)
            for dt, ts in groups.items()}


def average_gradients(params: Sequence[torch.Tensor], group) -> int:
    """Replace each parameter's gradient by its mean over the group: one
    all-reduce of a flat buffer a dtype.  Returns the bytes reduced."""
    if _world(group) == 1:
        return 0
    n = 0
    for flat, grads in _flat_by_dtype([p.grad for p in params]).values():
        _all_reduce(flat, pg=group.pg)
        flat /= group.world
        n += flat.numel() * flat.element_size()
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    return n


def reduce_metrics(metrics: Dict[str, torch.Tensor], group
                   ) -> Dict[str, torch.Tensor]:
    """A step's scalars at their global values: losses averaged over the
    ranks (each rank's loss has the global loss as its mean), ``diag/*``
    counters as the JAX package reduces them over the batch: the dropped
    counts summed, the column counts and cap hits by their maximum
    (models/lidar_encoder.py:566-617 of the JAX package).  Other keys (the
    gradient norm, already global) pass through."""
    if _world(group) == 1:
        return metrics
    out = dict(metrics)
    losses = [k for k in metrics if not k.startswith('diag/')
              and k != 'grad_norm']
    if losses:
        stacked = torch.stack([metrics[k].detach() for k in losses])
        _all_reduce(stacked, pg=group.pg)
        stacked /= group.world
        out.update(zip(losses, stacked.unbind()))
    for op, keys in ((dist.ReduceOp.SUM,
                      [k for k in metrics if k.startswith('diag/')
                       and 'dropped' in k]),
                     (dist.ReduceOp.MAX,
                      [k for k in metrics if k.startswith('diag/')
                       and 'dropped' not in k])):
        if keys:
            stacked = torch.stack([metrics[k] for k in keys])
            _all_reduce(stacked, op, group.pg)
            out.update(zip(keys, stacked.unbind()))
    return out


def broadcast_module(module: torch.nn.Module, group) -> None:
    """Every rank's parameters and buffers set to rank 0's, in place."""
    if _world(group) == 1:
        return
    src = dist.get_global_rank(group.pg, 0)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group.pg)


def broadcast_object(obj, group):
    """Rank 0's ``obj`` (picklable) on every rank of the group."""
    if _world(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group.pg, 0),
                               group=group.pg, device=comm_device(group))
    return box[0]


def barrier(group) -> None:
    """Wait until every rank of the group has reached here."""
    if _world(group) > 1:
        dist.barrier(group=group.pg)


def psum_metric_states(states, group):
    """Sum per-rank metric states (a dict, list or tuple of numpy arrays or
    tensors, the same layout on every rank) over the group; numpy in, numpy
    out.  World 1: the states as numpy."""
    if isinstance(states, dict):
        return {k: psum_metric_states(v, group) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return type(states)(psum_metric_states(v, group) for v in states)
    return sum_across_processes(states, group)


def sum_across_processes(state, group=None) -> np.ndarray:
    """Sum a host-side metric state over the ranks of the group.  World 1
    (or no group): identity."""
    local = np.asarray(state.cpu() if torch.is_tensor(state) else state)
    if _world(group) == 1:
        return local
    # a copy: the reduction is in place, and local may be the caller's
    t = torch.tensor(local, device=comm_device(group))
    dist.all_reduce(t, group=group.pg)
    return t.cpu().numpy()


def gather_across_processes(local, group=None) -> np.ndarray:
    """Stack the ranks' result arrays in rank order: (world, *shape).
    World 1 (or no group): ``local[None]``."""
    arr = np.asarray(local.cpu() if torch.is_tensor(local) else local)
    if _world(group) == 1:
        return arr[None]
    t = torch.tensor(arr, device=comm_device(group))
    out = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(out, t, group=group.pg)
    return torch.stack(out).cpu().numpy()


def combine_metrics(metrics: Sequence):
    """Fold many same-type metric objects into the first (host-side), as
    summing Lightning metric states across workers does."""
    first = metrics[0]
    total = first.state()
    for m in metrics[1:]:
        total = total + m.state()
    first.load_state(total)
    return first
