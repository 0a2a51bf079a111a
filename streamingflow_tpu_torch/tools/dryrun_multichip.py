"""Data-parallel dry run: one training step over n gloo ranks.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
n processes (one per rank, ``parallel/launch.py``), a micro camera + LiDAR
configuration, a global batch of n, one step of
``parallel.make_data_parallel_step`` each, first on the spconv8x backbone,
then on pillar8x, and one line per backbone::

    python -m streamingflow_tpu_torch.tools.dryrun_multichip [N]
        [--device cpu]

The ranks run on the card (``cuda:{rank % device_count}``: on one card they
share it, through gloo) unless given ``--device cpu``.

It fails unless every rank ends with a finite loss, the same loss and the
same parameters.
"""
from __future__ import annotations

import argparse
import time

import torch


def micro_config(backbone: str = 'pillar8x'):
    """The JAX dry run's micro configuration (``_flagship_cfg(micro=True)``
    of __graft_entry__.py): camera + LiDAR fusion, variable ODE step, every
    axis shrunk.  On spconv8x the port's column engine with 'winfuse' (the
    flagship's formulation) and column caps and a window plan sized to the
    128 x 128 x 25 grid."""
    from ..data import tiny_config
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.MODALITY.USE_CAMERA = True
    cfg.MODEL.FUTURE_PRED.USE_VARIABLE_ODE_STEP = True
    cfg.MODEL.IMPUTE = True
    cfg.PLANNING.ENABLED = False
    cfg.MODEL.LIDAR.BACKBONE = backbone
    cfg.IMAGE.FINAL_DIM = (16, 32)
    cfg.IMAGE.NAMES = ['CAM_FRONT']
    cfg.LIFT.X_BOUND = [-4.0, 4.0, 0.5]
    cfg.LIFT.Y_BOUND = [-4.0, 4.0, 0.5]
    cfg.LIFT.D_BOUND = [2.0, 6.0, 1.0]
    cfg.MODEL.ENCODER.OUT_CHANNELS = 8
    cfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS = 8
    cfg.MODEL.DISTRIBUTION.LATENT_DIM = 8
    cfg.MODEL.SMALL_ENCODER.FILTER_SIZE = 4
    cfg.DATASET.FRAME_SKIP = 20  # one grouped lidar observation
    se = cfg.MODEL.SPARSE_ENCODER
    se.POINT_CLOUD_RANGE = [-4.0, -4.0, -4.0, 4.0, 4.0, 3.68]
    se.VOXEL_SIZE = [0.0625, 0.0625, 0.32]
    se.SPARSE_SHAPE = (128, 128, 25)
    se.MAX_VOXELS = 512
    se.STAGE_CAPS = [512, 256, 128, 64]
    if backbone == 'spconv8x':
        se.ENGINE = 'column'
        se.Z_FORMULATION = 'winfuse'
        se.COLUMN_CAPS = [512, 768, 512, 256]
        se.WINDOW_BLOCK = 16
        se.WINFUSE_WINDOW = 64
    return cfg


def one_rank(backbone: str, n: int, device: str):
    """One data-parallel step of this rank on the micro configuration, on
    ``device`` ('cuda': the rank's card): (total loss, seconds, the sum of
    the parameters)."""
    from .. import build_trainer
    from ..data import make_batch
    from ..parallel import make_data_parallel_step, make_mesh
    t0 = time.time()
    cfg = micro_config(backbone)
    cfg.BATCHSIZE = n
    group = make_mesh(cfg.BATCHSIZE, device=device)
    trainer = build_trainer(cfg, seed=0, group=group)
    step = make_data_parallel_step(cfg, group)
    metrics = step(trainer, make_batch(cfg, n, seed=0, n_points=128),
                   torch.Generator(group.device).manual_seed(1))
    total = sum(float(p.detach().double().sum())
                for p in trainer.module.parameters())
    return float(metrics['total_loss']), time.time() - t0, total


def dryrun_multichip(n_ranks: int, device: str = 'cuda') -> None:
    """One step over ``n_ranks`` gloo processes on ``device`` ('cuda'
    unless asked for 'cpu'; raises when CUDA is absent), spconv8x then
    pillar8x, one line each."""
    import math

    from ..device import resolve_device
    from ..parallel.launch import spawn_ranks
    device = resolve_device(device).type
    for backbone in ('spconv8x', 'pillar8x'):
        label = ('spconv8x/' + micro_config(backbone).MODEL.SPARSE_ENCODER
                 .ENGINE if backbone == 'spconv8x' else backbone)
        t0 = time.time()
        out = spawn_ranks(one_rank, n_ranks, backbone, n_ranks, device)
        losses = {loss for loss, _, _ in out}
        params = {p for _, _, p in out}
        if len(losses) != 1 or len(params) != 1 or \
                not all(math.isfinite(v) for v in losses | params):
            raise AssertionError(f'dryrun_multichip({n_ranks}) [{label}]: '
                                 f'ranks disagree or diverge: {out}')
        print(f'dryrun_multichip({n_ranks}) ok [{label}] on {device}: '
              f'total_loss={losses.pop():.4f} ({time.time() - t0:.0f}s)',
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('n_ranks', nargs='?', type=int, default=2)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == '__main__':
    main()
