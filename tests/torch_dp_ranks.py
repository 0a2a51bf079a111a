"""What each rank computes for tests/test_torch_parallel.py, and the inputs
both sides share.

The ranks run in spawned processes (streamingflow_tpu_torch/parallel/
launch.py), so this module imports torch and the port only, never JAX: the
JAX side runs in the test's own process.  Every input is made from a seed
with numpy, the same in the ranks and in the test.
"""
import os

import numpy as np
import torch

import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.data import make_batch, tiny_config
from streamingflow_tpu_torch.data.dataloader import DataLoader
from streamingflow_tpu_torch.layers.trainmode import BatchNorm, BatchShard
from streamingflow_tpu_torch.models.lidar_encoder import MaskedBatchNorm
from streamingflow_tpu_torch.parallel import (complete_batches,
                                              gather_across_processes,
                                              make_data_parallel_step,
                                              make_mesh, psum_metric_states,
                                              sum_across_processes)
from streamingflow_tpu_torch.tools.dryrun_multichip import micro_config
from streamingflow_tpu_torch.training import losses as L
from streamingflow_tpu_torch.training.checkpoint import CheckpointManager
from streamingflow_tpu_torch.training.metrics import IntersectionOverUnion
from streamingflow_tpu_torch.training.trainer import compute_losses

WORLD = 2
BN_CASES = {'spatial': (4, 6, 5, 3), 'one_value_per_channel': (2, 6)}
MASKED_CASES = ('unequal_counts', 'rank1_holds_none')
STEP_BACKBONES = ('pillar8x', 'spconv8x')


# ----------------------------------------------------------------- inputs
def bn_inputs(case):
    """x (B, C, ...) channels-first, scale, bias, running mean and var."""
    rng = np.random.RandomState(1)
    shape = BN_CASES[case]
    c = shape[1]
    x = (3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)
    return (x, (1 + 0.1 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32),
            (1 + 0.1 * rng.rand(c)).astype(np.float32))


def masked_inputs(case, n=4, v=5, nz=3, c=4):
    """Fused columns x (N, V, nz*C) with mask (N, V, nz): each rank's
    clouds with a different number of active sites, or rank 1's none."""
    rng = np.random.RandomState(2)
    x = (1.0 + rng.randn(n, v, nz * c)).astype(np.float32)
    mask = rng.rand(n, v, nz) < np.array([0.8, 0.6, 0.3, 0.2])[:, None, None]
    if case == 'rank1_holds_none':
        mask[n // 2:] = False
    return (x, mask, (1 + 0.1 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32))


def loss_cfg():
    cfg = tiny_config()
    cfg.BATCHSIZE = WORLD
    return cfg


def loss_inputs(cfg):
    """Outputs, labels (B = 2) and task weights for compute_losses, float32
    channels-last; sample 1's offset and flow are masked everywhere."""
    rng = np.random.RandomState(3)
    b, s, h, w = WORLD, 3, 4, 4
    ign = cfg.DATASET.IGNORE_INDEX
    out = {'segmentation': rng.randn(b, s, h, w, 2),
           'instance_center': rng.randn(b, s, h, w, 1),
           'instance_offset': rng.randn(b, s, h, w, 2),
           'instance_flow': rng.randn(b, s, h, w, 2),
           'depth_prediction': rng.randn(b, 2, 1, h, w, 8)}
    labels = {'segmentation': rng.randint(0, 2, (b, s, h, w, 1)),
              'centerness': rng.rand(b, s, h, w, 1),
              'offset': rng.randn(b, s, h, w, 2),
              'flow': rng.randn(b, s, h, w, 2),
              'depths': rng.randint(0, 8, (b, 2, 1, h, w))}
    for k in ('offset', 'flow'):
        labels[k][rng.rand(b, s, h, w) < 0.4] = ign
        labels[k][1] = ign
    weights = {k: rng.randn() * 0.3 for k in
               ('segmentation', 'depths', 'centerness', 'offset', 'flow')}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    labels = {k: (v.astype(np.int32) if v.dtype.kind == 'i'
                  else v.astype(np.float32)) for k, v in labels.items()}
    return out, labels, {k: np.float32(v) for k, v in weights.items()}


def regression_inputs():
    """prediction, target (B = 4, S = 3, 4, 4, 2): rank 1's rows (2, 3)
    fully masked."""
    rng = np.random.RandomState(4)
    pred = rng.randn(4, 3, 4, 4, 2).astype(np.float32)
    target = rng.randn(4, 3, 4, 4, 2).astype(np.float32)
    target[rng.rand(4, 3, 4, 4) < 0.5] = 255
    target[2:] = 255
    return pred, target


def step_cfg(backbone):
    """The tiny camera + LiDAR configuration (pillar8x) or the micro one
    (spconv8x, tools/dryrun_multichip.py), global batch 2, every stochastic
    part on (PROBABILISTIC, dropout, drop-connect), fp64 throughout."""
    if backbone == 'pillar8x':
        cfg = tiny_config()
        cfg.MODEL.MODALITY.USE_LIDAR = True
        cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    else:
        cfg = micro_config('spconv8x')
    cfg.PROBABILISTIC.ENABLED = True
    cfg.BATCHSIZE = WORLD
    cfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'float64'
    return cfg


def step_batch(cfg):
    return make_batch(cfg, WORLD, seed=5, n_points=512)


def planning_step_cfg():
    """The tiny pillar8x step configuration with the planner on (9
    candidates, GRU state 16)."""
    cfg = step_cfg('pillar8x')
    cfg.PLANNING.ENABLED = True
    cfg.PLANNING.SAMPLE_NUM = 9
    cfg.PLANNING.GRU_STATE_SIZE = 16
    return cfg


def planning_step_batch(cfg):
    """step_batch with candidates that reach the occupied cells, and a goal
    point on rank 0's row only: whether a goal is set is one flag over the
    global batch, which rank 1 alone would not see."""
    batch = step_batch(cfg)
    rng = np.random.RandomState(9)
    batch['sample_trajectory'] = np.cumsum(rng.uniform(
        -1.0, 2.0, batch['sample_trajectory'].shape), axis=2).astype(
        np.float32)
    batch['target_point'][1] = 0.0
    return batch


def run_step(cfg, group=None, batch=None):
    """One fp64 step from the weights of seed 0 and the generator of seed
    3 on ``batch`` (step_batch by default): the data-parallel step on
    ``group``'s rank, else the one-process step on the global batch.
    Returns numpy: metrics, gradients (clipped, as the step leaves them),
    the module's state after the step and Adam's state."""
    trainer = P.build_trainer(cfg, device='cpu', seed=0, group=group)
    trainer.module.to(torch.float64)
    gen = torch.Generator().manual_seed(3)
    batch = step_batch(cfg) if batch is None else batch
    if group is None:
        metrics = P.train_step(trainer, batch, generator=gen)
    else:
        metrics = make_data_parallel_step(cfg, group)(trainer, batch, gen)
    opt = trainer.optimizer.state_dict()['state']
    names = [n for n, _ in trainer.module.named_parameters()]
    return dict(
        metrics={k: v.numpy() for k, v in metrics.items()},
        grads={n: p.grad.numpy().copy()
               for n, p in trainer.module.named_parameters()},
        state={k: v.numpy().copy()
               for k, v in trainer.module.state_dict().items()},
        adam={f'{names[i]}/{k}': v.numpy().copy()
              for i, st in opt.items() for k, v in st.items()
              if k != 'step'})


# ------------------------------------------------------------ rank's work
def _rows(a, group):
    b = len(a) // group.world
    return a[group.rank * b:(group.rank + 1) * b]


def _shard(group, total):
    b = total // group.world
    return BatchShard(group.rank * b, b, total, group.pg)


def _bn(case, group):
    x, scale, bias, mean, var = bn_inputs(case)
    bn = BatchNorm(x.shape[1], eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    bn.shard = _shard(group, len(x))
    out = bn(torch.from_numpy(_rows(x, group)))
    return (out.detach().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy())


def _masked(case, group):
    x, mask, scale, bias = masked_inputs(case)
    bn = MaskedBatchNorm(scale.shape[0]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.shard = _shard(group, len(x))
    out = bn(torch.from_numpy(_rows(x, group)),
             torch.from_numpy(_rows(mask, group)))
    return (out.detach().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy())


def _regression(group):
    pred, target = regression_inputs()
    shard = _shard(group, len(pred))
    return {norm: float(L.spatial_regression_loss(
        torch.from_numpy(_rows(pred, group)),
        torch.from_numpy(_rows(target, group)), norm=norm, n_present=2,
        future_discount=0.9, shard=shard)) for norm in (1, 2)}


def _losses(group):
    cfg = loss_cfg()
    out, labels, weights = loss_inputs(cfg)
    losses = compute_losses(
        {k: torch.from_numpy(_rows(v, group)) for k, v in out.items()},
        {k: torch.from_numpy(_rows(v, group)) for k, v in labels.items()},
        {k: torch.tensor(v) for k, v in weights.items()}, cfg,
        _shard(group, WORLD))
    return {k: float(v) for k, v in losses.items()}


def collect_inputs(rank):
    """A rank's local array and its IoU metric's (prediction, target)."""
    rng = np.random.RandomState(10 + rank)
    return (np.arange(6, dtype=np.int64).reshape(2, 3) + 10 * rank,
            rng.randint(0, 2, (2, 3, 8, 8)), rng.randint(0, 2, (2, 3, 8, 8)))


def _collect(group):
    local, pred, target = collect_inputs(group.rank)
    iou = IntersectionOverUnion(2)
    iou.update(pred, target)
    return dict(gathered=gather_across_processes(local, group),
                summed=sum_across_processes(local, group),
                tree=psum_metric_states({'a': local, 'b': [local * 2]},
                                        group),
                iou_state=sum_across_processes(iou.state(), group))


def _checkpoint(group, directory):
    """A data-parallel trainer saved after one step (rank 0 writes, every
    rank waits) and restored into a fresh one on every rank (rank 0 reads
    and broadcasts): the files each rank found after the save, and whether
    the restored state, Adam's included, equals the saved one."""
    cfg = step_cfg('pillar8x')
    cfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'auto'
    trainer = P.build_trainer(cfg, device='cpu', seed=0, group=group)
    make_data_parallel_step(cfg, group)(trainer, step_batch(cfg),
                                        torch.Generator().manual_seed(3))
    ckpt = CheckpointManager(directory)
    ckpt.save(1, trainer, cfg)
    found = sorted(os.listdir(directory))
    fresh = P.build_trainer(cfg, device='cpu', seed=1, group=group)
    if group.rank != 0:
        # a rank that cannot read the files still restores rank 0's state
        ckpt.restore_raw = None
    ckpt.restore(fresh)
    same = all(torch.equal(v, fresh.module.state_dict()[k])
               for k, v in trainer.module.state_dict().items())
    opt, got = (t.optimizer.state_dict()['state'] for t in (trainer, fresh))
    same_adam = all(torch.equal(v, got[i][k]) for i, st in opt.items()
                    for k, v in st.items())
    return dict(found=found, same=same, same_adam=same_adam,
                step=fresh.step)


class _Items:
    """A split of 12 items, 3 global batches of 4: item 3 (rank 1's
    second row of batch 0) and items 4, 5 (rank 0's rows of batch 1) are
    invalid."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return {'future_egomotion': np.zeros((3, 6), np.float32),
                'index': i,
                'status': 'invalid' if i in (3, 4, 5) else 'valid'}


def loader_items():
    return _Items()


def _complete(group):
    """The training loader's batches in step over the ranks: the indices
    of each batch complete_batches yields (None: skipped on every rank),
    and what the rank's plain iteration (validation's) gives: indices and
    batch_shard of each batch."""
    loader = DataLoader(loader_items(), 4, shuffle=False, drop_last=True,
                        shard=(group.rank, group.world))
    stepped = [None if b is None else b['index'].tolist()
               for b in complete_batches(loader, group)]
    plain = [(b['index'].tolist(), b.get('batch_shard')) for b in loader]
    return dict(stepped=stepped, plain=plain)


def fail_on_rank1():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if torch.distributed.get_rank() == 1:
        raise ValueError('planted failure on rank 1')
    torch.distributed.barrier()


def sleep_long():
    import time
    time.sleep(120)


def moments_step(backbone):
    """The one-process step through the ranks' global-moments path over a
    group of one (chip_smoke.py's 'moments' leg)."""
    import chip_smoke
    with chip_smoke._shard_path_of_one():
        return run_step(step_cfg(backbone), make_mesh(WORLD, device='cpu'))


def rank_work(directory):
    """Everything the test holds, on this rank of a world of 2;
    ``directory`` is shared by the ranks."""
    group = make_mesh(WORLD, device='cpu')
    assert group.world == WORLD and group.active
    return dict(
        checkpoint=_checkpoint(group, directory),
        rank=group.rank,
        bn={case: _bn(case, group) for case in BN_CASES},
        masked={case: _masked(case, group) for case in MASKED_CASES},
        regression=_regression(group), losses=_losses(group),
        collect=_collect(group), complete=_complete(group),
        steps={b: run_step(step_cfg(b), group) for b in STEP_BACKBONES})


def planning_rank_work():
    """The data-parallel fp64 step with the planner on this rank of a world
    of 2 (tests/test_torch_parallel_planning.py)."""
    group = make_mesh(WORLD, device='cpu')
    cfg = planning_step_cfg()
    return dict(rank=group.rank,
                step=run_step(cfg, group, planning_step_batch(cfg)))
