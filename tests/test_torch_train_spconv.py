"""The training slice on the spconv8x backbone: the port's ``train_step`` at
a tiny camera + spconv8x configuration ('winfuse', dense tail from stage 3,
the port's plain versions of K2 and K3 and its gradient), and the train
CLI's capacity warnings, on the CPU.

- the step returns the JAX step's ``diag/*`` capacity counters under the
  JAX names, finite losses, and every masked BN's running statistics moved;
- MODEL.REMAT and SPARSE_ENCODER.REMAT_LADDER, on or off in any
  combination, give the same losses, gradients and statistics (a
  recompute moves no statistic a second time);
- ``python -m streamingflow_tpu_torch.train`` with a column cap of 1 prints
  the capacity warning at its logging steps;
- (``slow``) the whole step against the JAX package's ``make_train_step``
  body in fp32, at the bars tests/test_torch_train_step.py holds the fp32
  pillar8x step to.  Its JAX side compiles the spconv8x train step, a
  compile of the class tests/test_multichip.py puts at minutes, so tier 1
  does not run it.
"""
import os
import sys

import numpy as np
import pytest
import torch

import streamingflow_tpu_torch as P
from streamingflow_tpu_torch import train
from streamingflow_tpu_torch.convert import state_to_flax
from streamingflow_tpu_torch.data import make_batch, tiny_config
from streamingflow_tpu_torch.layers.trainmode import Dropout
from streamingflow_tpu_torch.models.lidar_encoder import MaskedBatchNorm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures_nuscenes import make_mini_nuscenes  # noqa: E402

DIAGNOSTICS = {'lidar_dropped_sites_entry', 'lidar_columns_stage1',
               'lidar_columns_stage2', 'lidar_column_cap_hit_stage2',
               'lidar_columns_stage3', 'lidar_column_cap_hit_stage3'}


def _cfg():
    """tiny_config with camera + spconv8x LiDAR on an 8 m square (a 16 x 16
    BEV, the 128 x 128 x 25 sparse grid that spconv8x reduces to it):
    'pallas_patch' pool (its plain version), column caps and a window plan
    sized to the grid."""
    cfg = tiny_config()
    cfg.LIFT.X_BOUND = [-4.0, 4.0, 0.5]
    cfg.LIFT.Y_BOUND = [-4.0, 4.0, 0.5]
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.PROBABILISTIC.ENABLED = False
    cfg.MODEL.BEV_POOL_BACKEND = 'pallas_patch'
    cfg.MODEL.LIDAR.BACKBONE = 'spconv8x'
    se = cfg.MODEL.SPARSE_ENCODER
    se.ENGINE = 'column'
    se.Z_FORMULATION = 'winfuse'
    se.DENSE_TAIL_FROM_STAGE = 3
    se.POINT_CLOUD_RANGE = [-4.0, -4.0, -4.0, 4.0, 4.0, 3.68]
    se.SPARSE_SHAPE = (128, 128, 25)
    se.COLUMN_CAPS = [512, 768, 512, 256]
    se.WINDOW_BLOCK = 16
    se.WINFUSE_WINDOW = 64
    return cfg


def _step(cfg, seed=0):
    """One step from the weights of ``seed``, dropout off."""
    trainer = P.build_trainer(cfg, device='cpu', seed=seed)
    for m in trainer.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    before = state_to_flax(trainer.module)['batch_stats']
    metrics = P.train_step(trainer, make_batch(cfg, 1, seed=5,
                                               n_points=512))
    return trainer, metrics, before


@pytest.fixture(scope='module')
def plain_step():
    """The step without any remat."""
    cfg = _cfg()
    cfg.MODEL.REMAT = False
    cfg.MODEL.SPARSE_ENCODER.REMAT_LADDER = False
    return _step(cfg)


def test_spconv8x_step_returns_the_diagnostics(plain_step):
    trainer, metrics, before = plain_step
    assert {k[5:] for k in metrics if k.startswith('diag/')} == DIAGNOSTICS
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
        if k.startswith('diag/'):
            assert v.dtype == torch.int32 and v.dim() == 0, k
    assert int(metrics['diag/lidar_columns_stage1']) > 100
    assert int(metrics['diag/lidar_dropped_sites_entry']) == 0
    # every masked BN ran in train mode and moved its statistics
    stats = state_to_flax(trainer.module)['batch_stats']
    names = [n for n, m in trainer.module.named_modules()
             if isinstance(m, MaskedBatchNorm)]
    assert len(names) == 21
    for n in names:
        key = n.replace('.', '/') + '/mean'
        assert np.abs(stats[key] - before[key]).max() > 0, key
    assert float(metrics['grad_norm']) > 0


@pytest.mark.parametrize('remat,ladder', [(True, True), (True, False),
                                          (False, True)])
def test_remat_on_and_off_give_the_same_step(plain_step, remat, ladder):
    """MODEL.REMAT (the ladder as one checkpoint, its geometry outside)
    and REMAT_LADDER (a checkpoint a block) against the step without
    remat: the same losses and statistics, gradients to fp32 rounding."""
    want_trainer, want, _ = plain_step
    cfg = _cfg()
    cfg.MODEL.REMAT = remat
    cfg.MODEL.SPARSE_ENCODER.REMAT_LADDER = ladder
    trainer, got, _ = _step(cfg)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-6,
                                   err_msg=k)
    stats, want_stats = (state_to_flax(t.module)['batch_stats']
                         for t in (trainer, want_trainer))
    for k, w in want_stats.items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    grads, want_grads = (state_to_flax(t.module, grads=True)['params']
                         for t in (trainer, want_trainer))
    for k, w in want_grads.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


CLI_CFG = """
LOG_DIR: '{log_dir}'
TAG: 'spconv_cap'
EPOCHS: 1
BATCHSIZE: 1
N_WORKERS: 0
LOGGING_INTERVAL: 1
TIME_RECEPTIVE_FIELD: 2
N_FUTURE_FRAMES: 2
DATASET:
  DATAROOT: '{root}'
  VERSION: 'mini'
  FRAME_SKIP: 5
IMAGE:
  NAMES: ['CAM_FRONT', 'CAM_BACK']
  ORIGINAL_WIDTH: 160
  ORIGINAL_HEIGHT: 90
  FINAL_DIM: [32, 64]
  RESIZE_SCALE: 0.5
  TOP_CROP: 8
LIFT:
  X_BOUND: [-4.0, 4.0, 0.5]
  Y_BOUND: [-4.0, 4.0, 0.5]
  D_BOUND: [2.0, 10.0, 1.0]
  GT_DEPTH: False
MODEL:
  ENCODER:
    NAME: 'efficientnet-b0'
    OUT_CHANNELS: 16
  TEMPORAL_MODEL:
    START_OUT_CHANNELS: 16
  DISTRIBUTION:
    LATENT_DIM: 16
  SMALL_ENCODER:
    FILTER_SIZE: 8
  MODALITY:
    USE_CAMERA: True
    USE_LIDAR: True
  LIDAR:
    BACKBONE: 'spconv8x'
  SPARSE_ENCODER:
    POINT_CLOUD_RANGE: [-4.0, -4.0, -4.0, 4.0, 4.0, 3.68]
    VOXEL_SIZE: [0.0625, 0.0625, 0.32]
    SPARSE_SHAPE: [128, 128, 25]
    MAX_VOXELS: 4096
    ENGINE: 'column'
    Z_FORMULATION: 'winfuse'
    COLUMN_CAPS: [1, 1, 1, 1]
    WINDOW_BLOCK: 16
    WINFUSE_WINDOW: 64
SEMANTIC_SEG:
  PEDESTRIAN:
    ENABLED: False
  HDMAP:
    ENABLED: False
PLANNING:
  ENABLED: False
"""


def test_train_cli_warns_when_a_column_cap_is_hit(tmp_path, capsys):
    """Column caps of 1 drop sites at the entry and fill every strided
    conv's cap: the train CLI says so at its logging steps."""
    root = str(tmp_path / 'nusc')
    make_mini_nuscenes(root, n_scenes=2, n_samples=6, n_sweeps_between=1)
    path = tmp_path / 'spconv_cap.yml'
    path.write_text(CLI_CFG.format(root=root, log_dir=str(tmp_path / 'logs')))
    out = train.main(['--config-file', str(path), '--device', 'cpu'])
    printed = capsys.readouterr().out
    warnings = [ln for ln in printed.splitlines()
                if ln.startswith('WARNING: sparse-engine capacity event')]
    assert any('lidar_dropped_sites_entry' in ln and 'at step 1' in ln
               for ln in warnings), printed
    assert any('lidar_column_cap_hit_stage2 = 1' in ln for ln in warnings)
    # logged at every logging step (LOGGING_INTERVAL 1: each of 3 steps)
    assert len(out['losses']) == 3
    assert all(step['diag/lidar_columns_stage1'] == 1
               for step in out['losses'])


@pytest.mark.slow
def test_spconv8x_step_matches_jax():
    """The whole step against the JAX package's ``make_train_step`` body,
    the same random variables and batch, dropout off, 'winfuse' and the
    'scatter' pool on both sides, in fp32 with the bars
    test_torch_train_step.py holds the fp32 pillar8x step to (losses 1e-3
    relative, BN statistics 5e-3, gradient norm 10 %, the decoder heads'
    and task weights' gradient leaves 5e-2, the whole gradient's cosine
    above 0.8, every parameter within Adam's 2 * lr), and the diagnostics
    equal.  Not in fp64 as the pillar8x step: the JAX spconv8x ladder does
    not trace under x64 (lidar_encoder.py:334, reduce_window's init value is
    float64 and its operand float32; pallas_winfuse.py:159, lax.rem of an
    int32 and an int64)."""
    from streamingflow_tpu.config import Config as JConfig
    from test_torch_train_step import (_check_losses, _check_params,
                                       _check_stats, _jax_step, _leaf_close)
    from streamingflow_tpu_torch.convert import flatten, load_flax_variables

    pcfg = _cfg()
    pcfg.MODEL.BEV_POOL_BACKEND = 'scatter'
    jcfg = JConfig().merge_dict(pcfg.to_dict())
    cfg, batch, variables, want = _jax_step(x64=False, cfg=jcfg,
                                            n_points=512)
    want_diag = {k.split('/')[-2] if k.split('/')[-1].isdigit()
                 else k.split('/')[-1]: int(np.asarray(v).reshape(-1)[0])
                 for k, v in flatten(want['diag']).items()}
    trainer = P.build_trainer(pcfg, device='cpu')
    load_flax_variables(trainer.module, variables)
    for m in trainer.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    before = state_to_flax(trainer.module)['params']
    metrics = P.train_step(trainer, batch)
    tol = 1e-3
    assert {k[5:]: int(v) for k, v in metrics.items()
            if k.startswith('diag/')} == want_diag
    _check_losses({k: v for k, v in metrics.items()
                   if not k.startswith('diag/')}, want, tol)
    np.testing.assert_allclose(float(metrics['grad_norm']),
                               float(want['norm']), rtol=0.1)
    _check_stats(trainer, variables, want, 5 * tol)
    unclip = max(float(metrics['grad_norm']) / cfg.GRAD_NORM_CLIP, 1.0)
    grads = state_to_flax(trainer.module, grads=True)['params']
    raw = flatten(want['grads'])
    assert set(grads) == set(raw)
    heads = [k for k in raw if '_head_' in k or k.startswith('task_weights')]
    floor = float(np.median([np.abs(raw[k]).max() for k in heads]))
    for k in heads:
        _leaf_close(grads[k] * unclip, raw[k], 50 * tol, floor, f'grad {k}')
    dot = sum(float((grads[k] * raw[k]).sum()) for k in raw)
    norms = [np.sqrt(sum(float((t[k] ** 2).sum()) for k in raw))
             for t in (grads, raw)]
    print('spconv8x step: gradient cosine', dot / (norms[0] * norms[1]))
    assert dot / (norms[0] * norms[1]) > 0.8
    _check_params(trainer, before, want, cfg, 1.0)
