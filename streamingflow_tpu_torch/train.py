"""Training CLI: config -> dataloaders -> fit on one device.

Port of the JAX package's train.py (reference train.py:44-99): validation
each epoch, auto-resume from the latest checkpoint in the log dir, and the
``PRETRAINED`` warm start that drops the decoder.  One device and the plain
step (training/trainer.py::train_step); data-parallel runs are ROADMAP
item 13.

    python -m streamingflow_tpu_torch.train --config-file FILE [--device cpu]
        [KEY VALUE ...]

The model, the optimizer and the step run on ``--device`` ('cuda' unless
asked for 'cpu'; no CUDA and no ``--device cpu`` raises).  Loading, label
building for validation, post-processing and metrics run on the host.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import get_cfg, get_parser
from .data.dataloader import prepare_dataloaders
from .device import resolve_device
from .evaluate import OUTPUT_KEYS, forward_and_labels
from .training.checkpoint import CheckpointManager, warm_start
from .training.logging import (MetricsLogger, SimpleProfiler,
                               capacity_warnings)
from .training.trainer import build_trainer, train_step

SEED = 42


def run_validation(trainer, valloader, cfg) -> Dict[str, float]:
    """Epoch validation metrics (reference trainer.py:226-281 /
    validation_epoch_end): vehicle IoU (+pedestrian), panoptic PQ."""
    from .postprocess import predict_instance_segmentation_and_trajectories
    from .training.metrics import IntersectionOverUnion, PanopticMetric
    n_classes = len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS)
    metric_vehicle = IntersectionOverUnion(n_classes)
    metric_panoptic = PanopticMetric(n_classes=n_classes)
    metric_ped = (IntersectionOverUnion(n_classes)
                  if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED else None)
    rf = cfg.TIME_RECEPTIVE_FIELD
    for batch in valloader:
        labels, output, _ = forward_and_labels(trainer, batch, cfg)
        seg_pred = np.argmax(output['segmentation'], axis=-1)
        seg_label = labels['segmentation'][..., 0]
        metric_vehicle.update(seg_pred[:, rf - 1:], seg_label[:, rf - 1:])
        if metric_ped is not None:
            ped_pred = np.argmax(output['pedestrian'], axis=-1)
            metric_ped.update(ped_pred[:, rf - 1:],
                              labels['pedestrian'][..., 0][:, rf - 1:])
        if cfg.INSTANCE_SEG.ENABLED:
            consistent = predict_instance_segmentation_and_trajectories(
                {k: output[k] for k in OUTPUT_KEYS if k in output})
            metric_panoptic.update(consistent[:, rf - 1:],
                                   labels['instance'][:, rf - 1:])
    results = {'vehicle_iou': float(metric_vehicle.compute()[-1])}
    for k, v in metric_panoptic.compute().items():
        results[f'panoptic_{k}'] = float(v[-1])
    if metric_ped is not None:
        results['pedestrian_iou'] = float(metric_ped.compute()[-1])
    return results


def _to_device(batch: Dict, dev: torch.device) -> Dict:
    return {k: v.to(dev, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in batch.items()}


def main(argv: Optional[list] = None) -> Dict:
    """Run the training CLI; returns the trainer, the checkpoint directory,
    the per-step losses, the last validation metrics and the profiler."""
    parser = get_parser()
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_cfg(args)

    trainloader, valloader = prepare_dataloaders(
        cfg, pin_memory=dev.type == 'cuda')
    try:
        print(f'train batches: {len(trainloader)}  '
              f'val batches: {len(valloader)}')
        print(f'one device: {dev}')

        trainer = build_trainer(cfg, device=dev, seed=SEED)
        generator = torch.Generator(device=dev).manual_seed(SEED)
        if cfg.PRETRAINED.LOAD_WEIGHTS:
            # single-frame warm start, decoder keys dropped
            # (ref train.py:50-58)
            trainer, n = warm_start(trainer, cfg.PRETRAINED.PATH)
            print(f'warm start: loaded {n} tensors from {cfg.PRETRAINED.PATH} '
                  '(decoder dropped)')

        save_dir = os.path.join(cfg.LOG_DIR, cfg.TAG, 'checkpoints')
        ckpt = CheckpointManager(save_dir)
        start_epoch = 0
        latest = ckpt.latest_step()
        if latest is not None:
            print(f'resuming from checkpoint step {latest}')
            ckpt.restore(trainer, latest, generator=generator)
            start_epoch = latest

        logger = MetricsLogger(os.path.join(cfg.LOG_DIR, cfg.TAG))
        profiler = SimpleProfiler()
        losses, val_metrics = [], {}

        global_step = 0
        for epoch in range(start_epoch, cfg.EPOCHS):
            t0 = time.time()
            for batch in trainloader:
                with profiler.span('host_to_device'):
                    batch = _to_device(batch, dev)
                with profiler.span('train_step'):
                    metrics = train_step(trainer, batch, generator=generator)
                global_step += 1
                if global_step % cfg.LOGGING_INTERVAL == 0 or global_step == 1:
                    values = {k: float(v) for k, v in metrics.items()}
                    losses.append(values)
                    # per-loss scalars each step (reference trainer.py:406-407)
                    logger.scalars(values, global_step, prefix='step/')
                    print(f'epoch {epoch} step {global_step} '
                          f"loss {values['total_loss']:.4f} "
                          f'({time.time() - t0:.1f}s)', flush=True)
                    # the diagnostics are read here only, at logging steps
                    for line in capacity_warnings(
                            {k[5:]: v for k, v in values.items()
                             if k.startswith('diag/')}, global_step):
                        print(line, flush=True)
                if cfg.VIS_INTERVAL and global_step % cfg.VIS_INTERVAL == 0:
                    # BEV prediction video (reference trainer.py:396-409)
                    from .utils.visualisation import visualise_output
                    labels, output, _ = forward_and_labels(trainer, batch, cfg)
                    logger.video('train_outputs', visualise_output(
                        labels, output, n_present=cfg.TIME_RECEPTIVE_FIELD),
                        global_step)
            with profiler.span('checkpoint'):
                ckpt.save(epoch + 1, trainer, cfg, generator=generator)
            with profiler.span('validation'):
                val_metrics = run_validation(trainer, valloader, cfg)
            logger.scalars(val_metrics, epoch + 1, prefix='val/')
            print('val ' + ' '.join(f'{k}={v:.4f}'
                                    for k, v in val_metrics.items()),
                  flush=True)
            # uncertainty-weight tracking (reference trainer.py:426-486)
            logger.scalars({k: 1.0 / (2.0 * float(torch.exp(v.detach())))
                            for k, v in trainer.module.task_weights().items()},
                           epoch + 1, prefix='epoch_weight/')
            logger.flush()
            print(f'epoch {epoch} done in {time.time() - t0:.1f}s; '
                  f'checkpoint saved')
    finally:
        trainloader.close()
        valloader.close()
    logger.close()
    print(profiler.summary())
    return {'trainer': trainer, 'checkpoint_dir': save_dir,
            'losses': losses, 'val': val_metrics, 'profiler': profiler}


if __name__ == '__main__':
    main()
