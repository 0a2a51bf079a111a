"""Training harness: label preparation, uncertainty-weighted loss, one
optimisation step, and the evaluation forward.

Port of streamingflow_tpu/training/trainer.py.  The train module holds the
model and the per-task uncertainty log-variances (``1 / (2 e^w)`` factors)
under one parameter tree, as the JAX package's does.  A step is: warp the
labels into the present frame -> forward in train mode -> losses -> backward
-> clip the global gradient norm -> Adam with the weight decay added to the
gradient (not decoupled) -> new BatchNorm statistics (updated in place by
the forward).

:func:`build_trainer`, :func:`train_step` and :func:`eval_forward` run on
the card unless given ``device='cpu'``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import geometry as G
from ..config import Config
from ..device import resolve_device
from ..models.streamingflow import StreamingFlow
from . import losses as L


def to_tensor(v, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.to(device=device, dtype=dtype)


def batch_to_model_args(batch, cfg: Config, device=None,
                        image_dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, Optional[torch.Tensor]]:
    """Select the model's inputs from a batch dict (numpy or tensors) and
    place them on ``device`` ('cuda' unless asked for 'cpu').  Points,
    poses and times stay float32; ``image_dtype`` casts the images only (the
    mixed-precision forward runs bf16 images)."""
    dev = resolve_device(device)
    use_camera = cfg.MODEL.MODALITY.USE_CAMERA
    use_lidar = cfg.MODEL.MODALITY.USE_LIDAR

    def put(key, dtype=None):
        return to_tensor(batch[key], dev, dtype)

    return dict(
        image=put('image', image_dtype) if use_camera else None,
        intrinsics=put('intrinsics') if use_camera else None,
        extrinsics=put('extrinsics') if use_camera else None,
        future_egomotion=put('future_egomotion'),
        camera_timestamp=put('camera_timestamp'),
        points=put('points') if use_lidar else None,
        lidar_timestamp=put('lidar_timestamp'),
        target_timestamp=put('target_timestamp'))


def task_names(cfg: Config):
    """The tasks that carry a learned uncertainty weight, in the JAX
    package's order."""
    names = ['segmentation']
    if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED:
        names.append('pedestrian')
    if cfg.SEMANTIC_SEG.HDMAP.ENABLED:
        names.append('hdmap')
    if cfg.LIFT.GT_DEPTH:
        names.append('depths')
    if cfg.INSTANCE_SEG.ENABLED:
        names += ['centerness', 'offset']
    if cfg.INSTANCE_FLOW.ENABLED:
        names.append('flow')
    if cfg.PLANNING.ENABLED:
        names.append('planning')
    return names


class TaskWeights(nn.Module):
    """Learned homoscedastic task uncertainties: one zero-initialised scalar
    ``{name}_weight`` per task."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.names = task_names(cfg)
        for n in self.names:
            self.register_parameter(f'{n}_weight',
                                    nn.Parameter(torch.zeros(())))

    def forward(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, f'{n}_weight') for n in self.names}


class StreamingFlowTrainModule(nn.Module):
    """Model + task weights under one parameter tree (``model.*``,
    ``task_weights.*``).  The planning branch is not ported: the model
    raises for PLANNING.ENABLED."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.model = StreamingFlow(cfg)
        self.task_weights = TaskWeights(cfg)

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs), self.task_weights()


def prepare_future_labels(batch: Dict[str, torch.Tensor], cfg: Config
                          ) -> Dict[str, torch.Tensor]:
    """Warp the labels (tensors, channels-last (B, T, H, W, C); instance
    (B, T, H, W)) into the present reference frame."""
    rf = cfg.TIME_RECEPTIVE_FIELD
    spatial_extent = (cfg.LIFT.X_BOUND[1], cfg.LIFT.Y_BOUND[1])
    ego = batch['future_egomotion']
    labels: Dict[str, torch.Tensor] = {}

    def warp_both(x):
        past = G.cumulative_warp_features(
            x[:, :rf].float(), ego[:, :rf], mode='nearest',
            spatial_extent=spatial_extent)[:, :-1]
        future = G.cumulative_warp_features_reverse(
            x[:, rf - 1:].float(), ego[:, rf - 1:], mode='nearest',
            spatial_extent=spatial_extent)
        return torch.cat([past, future], dim=1)

    labels['gt_trajectory'] = batch.get('gt_trajectory')

    if cfg.LIFT.GT_DEPTH:
        ds = cfg.MODEL.ENCODER.DOWNSAMPLE
        depths = batch['depths'][:, :rf, :, ::ds, ::ds]
        depths = depths.clamp(cfg.LIFT.D_BOUND[0], cfg.LIFT.D_BOUND[1] - 1)
        labels['depths'] = (depths - cfg.LIFT.D_BOUND[0]).to(torch.int32)

    labels['segmentation'] = warp_both(batch['segmentation']).to(torch.int32)
    if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED:
        labels['pedestrian'] = warp_both(batch['pedestrian']).to(torch.int32)
    if cfg.INSTANCE_SEG.ENABLED:
        labels['instance'] = warp_both(
            batch['instance'][..., None]).to(torch.int32)[..., 0]
        labels['centerness'] = warp_both(batch['centerness'])
        labels['offset'] = warp_both(batch['offset'])
    if cfg.INSTANCE_FLOW.ENABLED:
        labels['flow'] = warp_both(batch['flow'])
    if cfg.SEMANTIC_SEG.HDMAP.ENABLED:
        labels['hdmap'] = batch['hdmap'].to(torch.int32)
    return labels


def compute_losses(output: Dict[str, torch.Tensor],
                   labels: Dict[str, torch.Tensor],
                   weights: Dict[str, torch.Tensor],
                   cfg: Config) -> Dict[str, torch.Tensor]:
    """Uncertainty-weighted loss dict: each task's loss times
    ``1 / (2 e^w)``, and ``w / 2`` under ``{task}_uncertainty``."""
    rf = cfg.TIME_RECEPTIVE_FIELD
    fd = cfg.FUTURE_DISCOUNT
    loss: Dict[str, torch.Tensor] = {}

    def factor(name):
        return 1.0 / (2.0 * torch.exp(weights[name]))

    seg = cfg.SEMANTIC_SEG
    loss['segmentation'] = factor('segmentation') * L.segmentation_loss(
        output['segmentation'], labels['segmentation'], seg.VEHICLE.WEIGHTS,
        n_present=rf, use_top_k=seg.VEHICLE.USE_TOP_K,
        top_k_ratio=seg.VEHICLE.TOP_K_RATIO, future_discount=fd)
    loss['segmentation_uncertainty'] = 0.5 * weights['segmentation']

    if seg.PEDESTRIAN.ENABLED:
        loss['pedestrian'] = factor('pedestrian') * L.segmentation_loss(
            output['pedestrian'], labels['pedestrian'],
            seg.PEDESTRIAN.WEIGHTS, n_present=rf,
            use_top_k=seg.PEDESTRIAN.USE_TOP_K,
            top_k_ratio=seg.PEDESTRIAN.TOP_K_RATIO, future_discount=fd)
        loss['pedestrian_uncertainty'] = 0.5 * weights['pedestrian']

    if seg.HDMAP.ENABLED:
        loss['hdmap'] = factor('hdmap') * L.hdmap_loss(
            output['hdmap'], labels['hdmap'], seg.HDMAP.WEIGHTS,
            seg.HDMAP.TRAIN_WEIGHT, seg.HDMAP.USE_TOP_K,
            seg.HDMAP.TOP_K_RATIO)
        loss['hdmap_uncertainty'] = 0.5 * weights['hdmap']

    if cfg.INSTANCE_SEG.ENABLED:
        loss['instance_center'] = factor('centerness') * \
            L.spatial_regression_loss(output['instance_center'],
                                      labels['centerness'], norm=2,
                                      n_present=rf, future_discount=fd)
        loss['centerness_uncertainty'] = 0.5 * weights['centerness']
        loss['instance_offset'] = factor('offset') * \
            L.spatial_regression_loss(output['instance_offset'],
                                      labels['offset'], norm=1, n_present=rf,
                                      ignore_index=cfg.DATASET.IGNORE_INDEX,
                                      future_discount=fd)
        loss['offset_uncertainty'] = 0.5 * weights['offset']

    if cfg.LIFT.GT_DEPTH and output.get('depth_prediction') is not None:
        loss['depths'] = factor('depths') * L.depth_loss(
            output['depth_prediction'], labels['depths'])
        loss['depths_uncertainty'] = 0.5 * weights['depths']

    if cfg.INSTANCE_FLOW.ENABLED:
        loss['instance_flow'] = factor('flow') * L.spatial_regression_loss(
            output['instance_flow'], labels['flow'], norm=1, n_present=rf,
            ignore_index=cfg.DATASET.IGNORE_INDEX, future_discount=fd)
        loss['flow_uncertainty'] = 0.5 * weights['flow']
    return loss


def make_optimizer(params, cfg: Config) -> torch.optim.Adam:
    """Adam (eps 1e-8 outside the square root, bias-corrected) with the
    weight decay added to the gradient; :func:`train_step` clips first."""
    return torch.optim.Adam(params, lr=cfg.OPTIMIZER.LR,
                            weight_decay=cfg.OPTIMIZER.WEIGHT_DECAY)


class Trainer:
    """The state of a training run: the train module, its optimizer, and the
    device they live on."""

    def __init__(self, cfg: Config, module: StreamingFlowTrainModule,
                 device: torch.device):
        self.cfg = cfg
        self.module = module
        self.device = device
        self.optimizer = make_optimizer(module.parameters(), cfg)
        self.step = 0


def build_trainer(cfg: Config, device=None, seed: Optional[int] = None
                  ) -> Trainer:
    """A trainer with fp32 parameters on ``device`` ('cuda' unless asked
    for 'cpu'; raises when CUDA is absent and no device was given).
    ``seed`` makes the random initial weights reproducible."""
    dev = resolve_device(device)
    if seed is not None:
        torch.manual_seed(seed)
    return Trainer(cfg, StreamingFlowTrainModule(cfg).to(dev), dev)


LABEL_KEYS = ('future_egomotion', 'segmentation', 'pedestrian', 'instance',
              'centerness', 'offset', 'flow', 'hdmap', 'depths',
              'gt_trajectory')


def train_step(trainer: Trainer, batch,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimisation step on ``batch`` (numpy or tensors, as
    data.make_batch lays it out).  ``generator`` (on the trainer's device)
    draws the dropout masks and the GRU-ODE's noise.  Returns the loss dict
    with ``total_loss``, the gradient norm before clipping (``grad_norm``)
    and ``diag/<name>`` for each of the forward's capacity diagnostics (the
    spconv8x encoder's, as the JAX step returns them), detached, on the
    device: nothing is read to the host."""
    cfg, module, dev = trainer.cfg, trainer.module, trainer.device
    labels = prepare_future_labels(
        {k: to_tensor(batch[k], dev) for k in LABEL_KEYS if k in batch}, cfg)
    # images in the parameters' dtype; points, poses and times stay float32
    model_args = batch_to_model_args(
        batch, cfg, device=dev,
        image_dtype=next(module.parameters()).dtype)
    module.train()
    trainer.optimizer.zero_grad(set_to_none=True)
    output, weights = module(**model_args, generator=generator)
    loss_dict = compute_losses(output, labels, weights, cfg)
    total = sum(loss_dict.values())
    total.backward()
    # a parameter the loss does not reach has a zero gradient, not none: the
    # weight decay still moves it, as in the JAX package's optimizer chain
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = torch.nn.utils.clip_grad_norm_(module.parameters(),
                                               cfg.GRAD_NORM_CLIP)
    trainer.optimizer.step()
    trainer.step += 1
    metrics = {'total_loss': total, **loss_dict, 'grad_norm': grad_norm}
    for k, v in module.model.diagnostics().items():
        metrics[f'diag/{k}'] = v
    return {k: v.detach() for k, v in metrics.items()}


def eval_forward(trainer: Trainer, batch,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, Optional[torch.Tensor]]:
    """Inference forward pass (running BN statistics, no dropout).  The
    forward's capacity diagnostics, where it has any (spconv8x), are under
    ``output['diagnostics']``, {name: int32 device scalar}, as the JAX
    package's eval_forward returns them."""
    model_args = batch_to_model_args(batch, trainer.cfg,
                                     device=trainer.device)
    trainer.module.eval()
    with torch.no_grad():
        output, _ = trainer.module(**model_args, generator=generator)
    diag = trainer.module.model.diagnostics()
    if diag:
        output['diagnostics'] = diag
    return output
