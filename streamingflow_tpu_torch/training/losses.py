"""Training losses, channels-last.

Port of streamingflow_tpu/training/losses.py: the same arithmetic
ignore-index masking and the fixed-k top-k (k from the static shapes).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _discounts(seq_len: int, n_present: int, future_discount: float,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """[1] * n_present ++ [gamma^1 ... gamma^future]."""
    future = future_discount ** torch.arange(
        1, seq_len - n_present + 1, dtype=dtype, device=device)
    return torch.cat([torch.ones(n_present, dtype=dtype, device=device),
                      future])


def _weighted_nll(logits: torch.Tensor, target: torch.Tensor, class_weights,
                  ignore_index: int) -> torch.Tensor:
    """Per-element class-weighted cross entropy over the last axis, zero
    where the target is ``ignore_index``."""
    valid = target != ignore_index
    safe = torch.where(valid, target, torch.zeros_like(target)).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if class_weights is not None:
        nll = nll * torch.as_tensor(class_weights, dtype=logp.dtype,
                                    device=logp.device)[safe]
    return nll * valid


def segmentation_loss(prediction: torch.Tensor, target: torch.Tensor,
                      class_weights: Sequence[float], n_present: int = 3,
                      ignore_index: int = 255, use_top_k: bool = False,
                      top_k_ratio: float = 1.0,
                      future_discount: float = 1.0) -> torch.Tensor:
    """Weighted CE with top-k hard-pixel mining and future discount.
    prediction (B, S, H, W, C) logits; target (B, S, H, W, 1) int labels."""
    b, s, h, w, _ = prediction.shape
    loss = _weighted_nll(prediction, target[..., 0], class_weights,
                         ignore_index)
    disc = _discounts(s, n_present, future_discount, loss.dtype, loss.device)
    flat = (loss * disc[None, :, None, None]).reshape(b, s, h * w)
    if use_top_k:
        flat = torch.topk(flat, int(top_k_ratio * h * w), dim=-1).values
    return flat.mean()


def spatial_regression_loss(prediction: torch.Tensor, target: torch.Tensor,
                            norm: int, n_present: int = 3,
                            ignore_index: int = 255,
                            future_discount: float = 1.0) -> torch.Tensor:
    """L1 / L2 regression, channel-summed, ignore-masked, discounted mean;
    zero when every element is masked.  prediction/target (B, S, H, W, C)."""
    mask = target[..., :1] != ignore_index
    if norm == 1:
        err = (prediction - target).abs()
    elif norm == 2:
        err = (prediction - target) ** 2
    else:
        raise ValueError(f'norm must be 1 or 2, got {norm}')
    loss = err.sum(dim=-1, keepdim=True)
    disc = _discounts(loss.shape[1], n_present, future_discount, loss.dtype,
                      loss.device)
    loss = loss * disc[None, :, None, None, None]
    n = mask.sum()
    total = (loss * mask).sum() / n.clamp(min=1)
    return torch.where(n == 0, torch.zeros_like(total), total)


def hdmap_loss(prediction: torch.Tensor, target: torch.Tensor, class_weights,
               training_weights, use_top_k, top_k_ratio,
               ignore_index: int = 255) -> torch.Tensor:
    """Per-element weighted CE over the present-frame HD map.
    prediction (B, H, W, 2 * n_elements) logits; target (B, n_elements, H,
    W)."""
    total = 0.0
    b, h, w, _ = prediction.shape
    for i in range(target.shape[1]):
        loss = _weighted_nll(prediction[..., 2 * i:2 * (i + 1)], target[:, i],
                             class_weights[i], ignore_index).reshape(b, h * w)
        if use_top_k[i]:
            loss = torch.topk(loss, int(top_k_ratio[i] * h * w),
                              dim=-1).values
        total = total + loss.mean() * training_weights[i]
    return total


def depth_loss(prediction: torch.Tensor, target: torch.Tensor,
               ignore_index: int = 255) -> torch.Tensor:
    """CE over depth bins.  prediction (B, S, N, H, W, D) logits; target
    (B, S, N, H, W) int bins."""
    return _weighted_nll(prediction, target, None, ignore_index).mean()


def probabilistic_loss(present_mu, present_log_sigma, future_mu,
                       future_log_sigma) -> torch.Tensor:
    """Gaussian KL(present || future)-style divergence."""
    var_future = torch.exp(2 * future_log_sigma)
    var_present = torch.exp(2 * present_log_sigma)
    kl = (present_log_sigma - future_log_sigma - 0.5
          + (var_future + (future_mu - present_mu) ** 2) / (2 * var_present))
    return kl.sum(dim=-1).mean()
