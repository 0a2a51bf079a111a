"""Training CLI: config -> dataloaders -> fit, on one device or
data-parallel over the ranks of a launcher.

Port of the JAX package's train.py (reference train.py:44-99): validation
each epoch, auto-resume from the latest checkpoint in the log dir, and the
``PRETRAINED`` warm start that drops the decoder.

    python -m streamingflow_tpu_torch.train --config-file FILE [--device cpu]
        [KEY VALUE ...]
    python -m torch.distributed.run --nproc_per_node N \
        -m streamingflow_tpu_torch.train --config-file FILE \
        [--dist-backend gloo] [KEY VALUE ...]

The model, the optimizer and the step run on ``--device`` ('cuda' unless
asked for 'cpu'; no CUDA and no ``--device cpu`` raises).  Under a launcher
(``WORLD_SIZE`` set) each rank joins the process group (NCCL on the card,
gloo on the CPU; ``--dist-backend gloo`` lets two ranks share one card),
runs on ``cuda:{LOCAL_RANK % device_count}``, and ``BATCHSIZE`` is the
global batch: the largest rank count that divides it takes part
(parallel/mesh.py), each loading and stepping on its rows; a global batch
in which a rank lost an item the dataset marked invalid is skipped on every
rank.  Validation
shards the items over those ranks and sums the metric states; rank 0 alone
writes checkpoints and logs.  Loading, label building for validation,
post-processing and metrics run on the host.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import get_cfg, get_parser
from .data.dataloader import prepare_dataloaders
from .evaluate import OUTPUT_KEYS, forward_and_labels
from .layers.trainmode import BatchShard
from .parallel import (complete_batches, init_distributed, make_mesh,
                       sum_across_processes)
from .parallel.collect import broadcast_module, broadcast_object
from .training.checkpoint import CheckpointManager, warm_start
from .training.logging import (MetricsLogger, NullLogger, SimpleProfiler,
                               capacity_warnings)
from .training.trainer import build_trainer, train_step

SEED = 42


def run_validation(trainer, valloader, cfg):
    """Epoch validation metrics (reference trainer.py:226-281 /
    validation_epoch_end): vehicle IoU (+pedestrian), panoptic PQ, and the
    metric states behind them (training.metrics.metric_states).  In a
    data-parallel run each rank forecasts its rows of each batch, with the
    noise of the whole batch, and the metric states are summed over the
    ranks."""
    from .postprocess import predict_instance_segmentation_and_trajectories
    from .training.metrics import (IntersectionOverUnion, PanopticMetric,
                                   metric_states)
    n_classes = len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS)
    metric_vehicle = IntersectionOverUnion(n_classes)
    metric_panoptic = PanopticMetric(n_classes=n_classes)
    metric_ped = (IntersectionOverUnion(n_classes)
                  if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED else None)
    rf = cfg.TIME_RECEPTIVE_FIELD
    for batch in valloader:
        shard = batch.get('batch_shard')
        labels, output, _ = forward_and_labels(
            trainer, batch, cfg,
            shard=None if shard is None else BatchShard(*shard))
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
    for m in (metric_vehicle, metric_panoptic, metric_ped):
        if m is not None:
            m.load_state(sum_across_processes(m.state(), trainer.group))
    results = {'vehicle_iou': float(metric_vehicle.compute()[-1])}
    for k, v in metric_panoptic.compute().items():
        results[f'panoptic_{k}'] = float(v[-1])
    if metric_ped is not None:
        results['pedestrian_iou'] = float(metric_ped.compute()[-1])
    return results, metric_states(vehicle=metric_vehicle,
                                  panoptic=metric_panoptic,
                                  pedestrian=metric_ped)


def _to_device(batch: Dict, dev: torch.device) -> Dict:
    return {k: v.to(dev, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in batch.items()}


def main(argv: Optional[list] = None) -> Dict:
    """Run the training CLI; returns the trainer, the checkpoint directory,
    the per-step losses, the last validation metrics and their metric
    states, the profiler and the rank's data-parallel group (a rank that
    takes no step returns its group only)."""
    parser = get_parser()
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--dist-backend', default=None,
                        help='process-group backend under a launcher: '
                             "'nccl' on the card, 'gloo' on the CPU by "
                             "default; 'gloo' lets ranks share one card")
    args = parser.parse_args(argv)
    cfg = get_cfg(args)
    owned = not dist.is_initialized()
    dev = init_distributed(args.device, args.dist_backend)
    group = make_mesh(cfg.BATCHSIZE, device=dev)
    try:
        if not group.active:
            print(f'rank {dist.get_rank()}: a global batch of '
                  f'{cfg.BATCHSIZE} shards over {group.world} rank(s); this '
                  f'rank takes no step', flush=True)
            return {'group': group}
        return _fit(cfg, dev, group)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _fit(cfg, dev, group) -> Dict:
    main_rank = group.is_main

    def say(*a, **kw):
        if main_rank:
            print(*a, **kw)

    trainloader, valloader = prepare_dataloaders(
        cfg, pin_memory=dev.type == 'cuda', group=group)
    try:
        say(f'train batches: {len(trainloader)}  '
            f'val batches: {len(valloader)}')
        say(f'data-parallel over {group.world} rank(s): {dev}'
            if group.world > 1 else f'one device: {dev}')

        trainer = build_trainer(cfg, device=dev, seed=SEED, group=group)
        generator = torch.Generator(device=dev).manual_seed(SEED)
        if cfg.PRETRAINED.LOAD_WEIGHTS:
            # single-frame warm start, decoder keys dropped
            # (ref train.py:50-58)
            trainer, n = warm_start(trainer, cfg.PRETRAINED.PATH)
            broadcast_module(trainer.module, group)
            say(f'warm start: loaded {n} tensors from {cfg.PRETRAINED.PATH} '
                '(decoder dropped)')

        save_dir = os.path.join(cfg.LOG_DIR, cfg.TAG, 'checkpoints')
        ckpt = CheckpointManager(save_dir)
        start_epoch = 0
        latest = broadcast_object(ckpt.latest_step(), group)
        if latest is not None:
            say(f'resuming from checkpoint step {latest}')
            ckpt.restore(trainer, latest, generator=generator)
            start_epoch = latest

        logger = (MetricsLogger(os.path.join(cfg.LOG_DIR, cfg.TAG))
                  if main_rank else NullLogger())
        profiler = SimpleProfiler()
        losses, val_metrics, val_states = [], {}, {}

        global_step = 0
        for epoch in range(start_epoch, cfg.EPOCHS):
            t0 = time.time()
            for batch in complete_batches(trainloader, group):
                if batch is None:
                    say(f'epoch {epoch}: a global batch skipped: a rank '
                        'lost items the dataset marked invalid', flush=True)
                    continue
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
                    say(f'epoch {epoch} step {global_step} '
                        f"loss {values['total_loss']:.4f} "
                        f'({time.time() - t0:.1f}s)', flush=True)
                    # the diagnostics are read here only, at logging steps
                    for line in capacity_warnings(
                            {k[5:]: v for k, v in values.items()
                             if k.startswith('diag/')}, global_step):
                        say(line, flush=True)
                if cfg.VIS_INTERVAL and global_step % cfg.VIS_INTERVAL == 0 \
                        and main_rank:
                    # BEV prediction video (reference trainer.py:396-409)
                    from .utils.visualisation import visualise_output
                    labels, output, _ = forward_and_labels(trainer, batch, cfg)
                    logger.video('train_outputs', visualise_output(
                        labels, output, n_present=cfg.TIME_RECEPTIVE_FIELD),
                        global_step)
            with profiler.span('checkpoint'):
                ckpt.save(epoch + 1, trainer, cfg, generator=generator)
            with profiler.span('validation'):
                val_metrics, val_states = run_validation(trainer,
                                                         valloader, cfg)
            logger.scalars(val_metrics, epoch + 1, prefix='val/')
            say('val ' + ' '.join(f'{k}={v:.4f}'
                                  for k, v in val_metrics.items()),
                flush=True)
            say('val_states ' + json.dumps(val_states), flush=True)
            # uncertainty-weight tracking (reference trainer.py:426-486)
            logger.scalars({k: 1.0 / (2.0 * float(torch.exp(v.detach())))
                            for k, v in trainer.module.task_weights().items()},
                           epoch + 1, prefix='epoch_weight/')
            logger.flush()
            say(f'epoch {epoch} done in {time.time() - t0:.1f}s; '
                f'checkpoint saved')
    finally:
        trainloader.close()
        valloader.close()
    logger.close()
    say(profiler.summary())
    return {'trainer': trainer, 'checkpoint_dir': save_dir,
            'losses': losses, 'val': val_metrics, 'val_states': val_states,
            'profiler': profiler, 'group': group}


if __name__ == '__main__':
    main()
