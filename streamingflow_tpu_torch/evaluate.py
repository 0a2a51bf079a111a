"""Standard evaluation: IoU and PQ (VPQ) over the validation split.

Port of the JAX package's evaluate.py (reference evaluate.py:30-350):
restores a checkpoint, runs the forward over the val split on the card,
applies the host-side instance post-processing and prints the metric table.

    python -m streamingflow_tpu_torch.evaluate --checkpoint LOG_DIR/TAG/checkpoints
        [--dataroot DIR] [--version mini] [--device cpu] [--plot DIR]

The model and its forward run on ``--device`` ('cuda' unless asked for
'cpu'; no CUDA and no ``--device cpu`` raises).  Loading, label warps,
post-processing and metrics run on the host.  PLANNING.ENABLED raises: the
planning branch and its metric are ROADMAP item 15.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import get_cfg
from .device import resolve_device
from .training.trainer import (LABEL_KEYS, build_trainer, eval_forward,
                               prepare_future_labels)

OUTPUT_KEYS = ('segmentation', 'instance_center', 'instance_offset',
               'instance_flow')


def get_eval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='StreamingFlow evaluation (PyTorch port)')
    parser.add_argument('--checkpoint', default=None,
                        help='checkpoint directory (LOG_DIR/TAG/checkpoints)')
    parser.add_argument('--dataroot', default=None)
    parser.add_argument('--version', default=None,
                        help="dataset version, e.g. 'mini' or 'trainval'")
    parser.add_argument('--future-frames', type=int, default=None,
                        help='override N_FUTURE_FRAMES (horizon sweep)')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--plot', default=None, metavar='DIR',
                        help='save prediction-vs-label panels to DIR '
                             '(reference evaluate.py plot_prediction:218)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--config-file', default='')
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    return parser


def build_eval_state(args, cfg_mutator=None):
    """(cfg, checkpoint manager or None) from the parsed arguments: the
    checkpoint's own config when there is one, else --config-file and
    opts."""
    from .training.checkpoint import CheckpointManager
    if args.checkpoint:
        ckpt = CheckpointManager(args.checkpoint)
        cfg = ckpt.load_cfg()
    else:
        ckpt = None
        cfg = get_cfg(args)
    if args.dataroot:
        cfg.DATASET.DATAROOT = args.dataroot
    if args.version:
        cfg.DATASET.VERSION = args.version
    if args.future_frames is not None:
        cfg.N_FUTURE_FRAMES = args.future_frames
    cfg.BATCHSIZE = args.batch_size
    if cfg_mutator is not None:
        cfg_mutator(cfg)
    return cfg, ckpt


def forward_and_labels(trainer, batch: Dict, cfg
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray], float]:
    """The eval forward of a loader batch on the trainer's device, and the
    batch's labels warped into the present frame on the host.  Returns
    (labels, outputs) as float32/int numpy, and the forward's seconds
    (host clock, the device synchronised)."""
    dev = trainer.device
    labels = prepare_future_labels(
        {k: batch[k] for k in LABEL_KEYS if k in batch}, cfg)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    output = eval_forward(trainer, batch)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    out = {k: v.float().cpu().numpy() for k, v in output.items()
           if torch.is_tensor(v)}
    lab = {k: v.cpu().numpy() for k, v in labels.items()
           if torch.is_tensor(v)}
    return lab, out, seconds


def run_eval(cfg, ckpt, short_interval: bool = False, plot_dir=None,
             eval_interval: int = 1, device=None) -> Dict:
    """Metric loop over the validation split.

    ``eval_interval`` thins the *future* target-timestamp lattice by that
    stride (units of the lattice step; reference evaluate_streaming.py
    :118-126) and subsamples the labels in lockstep at metric-update time
    (reference :142, :164) so predictions and multisweep labels always have
    the same T.  Returns the metrics and the forward times
    (``forward_s``)."""
    from .data.dataloader import prepare_dataloaders
    from .postprocess import predict_instance_segmentation_and_trajectories
    from .training.metrics import IntersectionOverUnion, PanopticMetric
    from .utils.visualisation import visualise_output

    dev = resolve_device(device)
    # the model first: an unported option (PLANNING.ENABLED) raises here
    trainer = build_trainer(cfg, device=dev, seed=0)
    if ckpt is not None and ckpt.latest_step() is not None:
        ckpt.restore(trainer)
    _, valloader = prepare_dataloaders(cfg, pin_memory=dev.type == 'cuda')
    n_classes = len(cfg.SEMANTIC_SEG.VEHICLE.WEIGHTS)
    metric_vehicle = IntersectionOverUnion(n_classes)
    metric_panoptic = PanopticMetric(n_classes=n_classes)
    metric_pedestrian = (IntersectionOverUnion(n_classes)
                         if cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED else None)
    if plot_dir:
        os.makedirs(plot_dir, exist_ok=True)

    rf = cfg.TIME_RECEPTIVE_FIELD
    t_fwd = []

    def sub(label_seq):
        """Label future subsample in lockstep with the thinned targets
        (applies to [:, rf-1:] slices; reference evaluate_streaming.py:142)."""
        return label_seq[:, ::eval_interval] if eval_interval != 1 \
            else label_seq

    try:
        for i, batch in enumerate(valloader):
            if eval_interval != 1:
                tt = batch['target_timestamp']
                batch['target_timestamp'] = torch.cat(
                    [tt[:, :rf - 1], tt[:, rf - 1:][:, ::eval_interval]],
                    dim=1)
            labels, output, seconds = forward_and_labels(trainer, batch, cfg)
            t_fwd.append(seconds)

            seg_pred = np.argmax(output['segmentation'], axis=-1)
            seg_label = labels['segmentation'][..., 0]
            metric_vehicle.update(seg_pred[:, rf - 1:],
                                  sub(seg_label[:, rf - 1:]))

            if metric_pedestrian is not None:
                ped_pred = np.argmax(output['pedestrian'], axis=-1)
                ped_label = labels['pedestrian'][..., 0]
                metric_pedestrian.update(ped_pred[:, rf - 1:],
                                         sub(ped_label[:, rf - 1:]))

            consistent = predict_instance_segmentation_and_trajectories(
                {k: output[k] for k in OUTPUT_KEYS if k in output},
                short_interval=short_interval)
            metric_panoptic.update(consistent[:, rf - 1:],
                                   sub(labels['instance'][:, rf - 1:]))

            if plot_dir is not None:
                frames = visualise_output(labels, output, n_present=rf)
                _save_panels(frames, os.path.join(plot_dir, f'sample_{i:05d}'))
    finally:
        valloader.close()

    results = {'iou': metric_vehicle.compute(),
               'pq': metric_panoptic.compute()}
    print('==== evaluation results ====')
    print(f"vehicle IoU: {results['iou']}")
    for k, v in results['pq'].items():
        print(f'{k}: {v}')
    if metric_pedestrian is not None:
        results['pedestrian_iou'] = metric_pedestrian.compute()
        print(f"pedestrian IoU: {results['pedestrian_iou']}")
    if t_fwd:
        print(f'mean forward time: {np.mean(t_fwd[1:] or t_fwd):.3f}s')
    results['forward_s'] = t_fwd
    return results


def _save_panels(frames: np.ndarray, prefix: str) -> None:
    """Write (T, H, W, 3) uint8 panels as PNGs (one per timestep), or one
    .npy where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        np.save(prefix + '.npy', frames)
        return
    for t, frame in enumerate(frames):
        Image.fromarray(frame).save(f'{prefix}_t{t}.png')


def main(argv: Optional[list] = None) -> Dict:
    args = get_eval_parser().parse_args(argv)
    resolve_device(args.device)
    cfg, ckpt = build_eval_state(args)
    return run_eval(cfg, ckpt, plot_dir=args.plot, device=args.device)


if __name__ == '__main__':
    main()
