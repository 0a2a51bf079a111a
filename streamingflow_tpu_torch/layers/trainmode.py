"""What differs between evaluation and training inside the layers: batch
normalisation with batch statistics, dropout masks, and rematerialisation.

The rules are those of the JAX package's flax modules, where they differ
from ``torch.nn``:

* ``flax.linen.BatchNorm`` moves its running variance toward the *biased*
  batch variance (``torch.nn.BatchNorm*`` takes the unbiased one), and
  normalises a batch of one value per channel (variance 0) where
  ``F.batch_norm`` refuses it.
* Dropout and drop-connect masks come from the ``torch.Generator`` the
  model's forward is given (:func:`set_generator`), not from the global
  generator, as the GRU-ODE's noise does.
* ``MODEL.REMAT`` recomputes a sub-module in the backward pass
  (:func:`remat`).  The recompute must see the masks of the first run, and
  must not move the running statistics a second time.

Under data parallelism (parallel/mesh.py) each rank holds a shard of the
global batch (:class:`BatchShard`, set by :func:`set_shard`): batch norms
take their statistics over the global batch, and random draws are made at
the global batch's shape, each rank keeping its rows, so that every sample
meets the statistics and the noise of the one-process step.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collect import all_reduce_sum


class BatchShard(NamedTuple):
    """This rank's samples ``[start, start + size)`` of a global batch of
    ``total``, and the process group ``pg`` whose ranks hold the rest
    (None: no collective, as in an evaluation forward)."""
    start: int
    size: int
    total: int
    pg: Optional[object] = None


def set_shard(module: nn.Module, shard: Optional[BatchShard]) -> None:
    """Give every module under ``module`` that draws or takes statistics
    over the batch (a class with a ``shard`` attribute) the shard of this
    forward; None: the batch is the whole batch."""
    for m in module.modules():
        if hasattr(type(m), 'shard'):
            m.shard = shard


def shard_draw(draw: Callable, shape, shard: Optional[BatchShard]):
    """``draw(shape)`` as the one-process forward makes it: at the global
    batch's shape, this shard's rows.  The leading axis of ``shape`` is
    batch-major (``size`` samples of k rows each: B, or B*S*N images)."""
    if shard is None or shard.size == shard.total:
        return draw(tuple(shape))
    k, rest = divmod(shape[0], shard.size)
    if rest:
        raise ValueError(f'a leading axis of {shape[0]} over a shard of '
                         f'{shard.size} samples')
    full = draw((shard.total * k, *shape[1:]))
    return full[shard.start * k:(shard.start + shard.size) * k]


def global_moments(s1: torch.Tensor, s2: torch.Tensor, n: torch.Tensor,
                   pg):
    """(Σx, Σx², count) summed over the ranks of ``pg``, differentiably."""
    c = s1.shape[0]
    s = all_reduce_sum(torch.cat([s1, s2, n.reshape(1).to(s1.dtype)]), pg)
    return s[:c], s[c:2 * c], s[2 * c]


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Batch norm over every axis but the channel axis 1, any rank.
    Evaluation: the running statistics.  Training: the batch mean and
    biased variance normalise, and both move the running statistics by
    ``momentum`` (= 1 - the flax momentum)."""

    # False while a rematerialised region runs again in the backward pass
    update_stats = True
    # the global batch this forward's batch is a shard of (set_shard)
    shard: Optional[BatchShard] = None

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(f'expected (B, C, ...) input, got {input.dim()}D')

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.shard is not None and self.shard.pg is not None:
            out, mean, var = self._global_batch_norm(x, self.shard.pg)
            self._move_stats(mean, var)
            return out
        if x.numel() == x.shape[1]:
            # one value per channel, which F.batch_norm refuses: the mean is
            # x and the variance 0, so x - mean is 0 whatever x is, the
            # output is the bias and no gradient reaches x or the scale
            shape = [1, -1] + [1] * (x.dim() - 2)
            mean = x.detach().reshape(-1)
            invstd = torch.full_like(mean, self.eps ** -0.5)
            centred = x - x.mean(dim=[0, *range(2, x.dim())], keepdim=True)
            out = (centred * self.eps ** -0.5 * self.weight.view(shape)
                   + self.bias.view(shape))
        else:
            # one pass gives the output and the batch statistics
            out, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        # the biased batch variance, back from 1 / sqrt(var + eps), in fp32
        # at least (fp64 stays fp64)
        invstd = invstd.detach().to(torch.promote_types(invstd.dtype,
                                                        torch.float32))
        self._move_stats(mean, (invstd ** -2 - self.eps).clamp_(min=0.0))
        return out

    def _move_stats(self, mean, var):
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(
                    mean.detach().to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(
                    var.detach().to(self.running_var.dtype), self.momentum)

    def _global_batch_norm(self, x, pg):
        """Batch norm over the global batch, as flax computes it under a
        sharded batch: per-channel Σx, Σx² (fp32 at least) and the count
        summed over the ranks in one all-reduce, mean E[x], biased variance
        max(E[x²] - E[x]², 0).  The count is global, so one value per
        channel on a rank is no special case.  Returns (output, mean,
        variance)."""
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        s1, s2, n = global_moments(
            xf.sum(dims), (xf * xf).sum(dims),
            torch.tensor(x.numel() // x.shape[1], device=x.device), pg)
        mean = s1 / n
        var = (s2 / n - mean * mean).clamp(min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        out = ((xf - mean.view(shape)) * scale.view(shape)
               + self.bias.to(xf.dtype).view(shape))
        return out.to(x.dtype), mean, var


class Dropout(nn.Module):
    """Inverted dropout (kept values scaled by 1 / keep), masks drawn from
    ``generator`` (None: the global one).  ``per_sample`` draws one value
    per batch element, the drop-connect of a residual branch."""

    # the global batch this forward's batch is a shard of (set_shard)
    shard: Optional[BatchShard] = None

    def __init__(self, rate: float, per_sample: bool = False):
        super().__init__()
        self.rate = rate
        self.per_sample = per_sample
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = ((x.shape[0],) + (1,) * (x.dim() - 1) if self.per_sample
                 else x.shape)
        mask = shard_draw(lambda s: torch.rand(s, generator=self.generator,
                                               device=x.device),
                          shape, self.shard) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_generator(module: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Give every :class:`Dropout` under ``module`` the generator to draw
    from."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def remat(fn: Callable, module: nn.Module,
          generator: Optional[torch.Generator], *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant).  ``module`` holds the
    layers ``fn`` runs.  ``checkpoint`` replays only the global generators,
    so the recompute rewinds ``generator`` to the state of the first run
    (and puts it back after), and it freezes the running statistics of
    ``module``'s batch norms, which the first run already moved."""
    first_state = None if generator is None else generator.get_state()
    runs = 0

    def run(*a):
        nonlocal runs
        runs += 1
        if runs == 1:
            return fn(*a)
        norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
        if generator is not None:
            resume = generator.get_state()
            generator.set_state(first_state)
        for m in norms:
            m.update_stats = False
        try:
            return fn(*a)
        finally:
            for m in norms:
                m.update_stats = True
            if generator is not None:
                generator.set_state(resume)

    return checkpoint(run, *args, use_reentrant=False)
