"""The port's CLIs end to end on the on-disk fixture, on the CPU.

- ``train``: dataloaders -> steps -> an epoch checkpoint -> validation ->
  auto-resume, as tests/test_cli_train.py holds the JAX CLI; on the camera
  micro config and on its camera + LiDAR (pillar8x) variant;
- ``evaluate``, ``evaluate_streaming`` (``--eval-interval`` 1 and 2) and
  ``evaluate_datastream`` print the JAX CLIs' metric keys;
- with JAX weights carried across (an orbax checkpoint converted by
  convert.save_flax_variables_as_checkpoint), the port's ``evaluate`` gives
  the JAX ``evaluate``'s vehicle IoU and PQ within 0.01, and its
  segmentation (read from the ``--plot`` panels of both) agrees on at
  least 99.9% of the pixels;
- without ``--device`` and without CUDA, every CLI raises naming CUDA.
"""
import glob
import os
import re
import sys

import numpy as np
import optax
import pytest
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from fixtures_nuscenes import make_mini_nuscenes  # noqa: E402

from streamingflow_tpu.config import load_cfg as jload_cfg  # noqa: E402
from streamingflow_tpu.data import make_batch  # noqa: E402
from streamingflow_tpu.training import trainer as JT  # noqa: E402
from streamingflow_tpu.training.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from streamingflow_tpu_torch import (evaluate, evaluate_datastream,  # noqa
                                     evaluate_streaming, train)
from streamingflow_tpu_torch.config import Config as PConfig  # noqa: E402
from streamingflow_tpu_torch.convert import \
    save_flax_variables_as_checkpoint  # noqa: E402

from torch_parity import init_jax, jnp_tree  # noqa: E402

MICRO = """
LOG_DIR: '{log_dir}'
TAG: '{tag}'
EPOCHS: 1
BATCHSIZE: 1
N_WORKERS: 0
LOGGING_INTERVAL: 1
VIS_INTERVAL: 2
TIME_RECEPTIVE_FIELD: 2
N_FUTURE_FRAMES: 2
DATASET:
  DATAROOT: '{root}'
  VERSION: 'mini'
  FRAME_SKIP: 5
  MULTISWEEP_NSWEEPS: 2
IMAGE:
  NAMES: ['CAM_FRONT', 'CAM_BACK']
  ORIGINAL_WIDTH: 160
  ORIGINAL_HEIGHT: 90
  FINAL_DIM: [32, 64]
  RESIZE_SCALE: 0.5
  TOP_CROP: 8
LIFT:
  X_BOUND: [-16.0, 16.0, 0.5]
  Y_BOUND: [-16.0, 16.0, 0.5]
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
    USE_LIDAR: {lidar}
  LIDAR:
    BACKBONE: 'pillar8x'
    TILE_SORTED_POINTS: True
  SPARSE_ENCODER:
    POINT_CLOUD_RANGE: [-16.0, -16.0, -4.0, 16.0, 16.0, 3.68]
    VOXEL_SIZE: [0.0625, 0.0625, 0.32]
SEMANTIC_SEG:
  PEDESTRIAN:
    ENABLED: False
  HDMAP:
    ENABLED: False
PLANNING:
  ENABLED: False
"""
METRIC_KEYS = ('vehicle IoU:', 'pq:', 'sq:', 'rq:', 'mean forward time:')


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('nusc_cli'))
    make_mini_nuscenes(root, n_scenes=2, n_samples=6, n_sweeps_between=1)
    log_dir = str(tmp_path_factory.mktemp('cli_logs'))

    def write_cfg(tag, lidar=False):
        path = os.path.join(log_dir, f'{tag}.yml')
        with open(path, 'w') as f:
            f.write(MICRO.format(root=root, log_dir=log_dir, tag=tag,
                                 lidar=lidar))
        return path
    return write_cfg, log_dir


@pytest.fixture(scope='module')
def trained(env):
    """The camera micro config trained for one epoch by the port."""
    write_cfg, log_dir = env
    cfg_yml = write_cfg('micro')
    out = train.main(['--config-file', cfg_yml, '--device', 'cpu'])
    return cfg_yml, out


def _checkpoint_steps(ckpt_dir):
    return sorted(d for d in os.listdir(ckpt_dir) if d.isdigit())


def test_train_end_to_end_and_resume(env, trained, capsys):
    cfg_yml, out = trained
    _, log_dir = env
    ckpt_dir = os.path.join(log_dir, 'micro', 'checkpoints')
    assert out['checkpoint_dir'] == ckpt_dir
    assert _checkpoint_steps(ckpt_dir) == ['1']
    assert os.path.exists(os.path.join(ckpt_dir, '1', 'checkpoint.pt'))
    assert len(out['losses']) == 3
    assert all(np.isfinite(v) for step in out['losses']
               for v in step.values())
    assert set(out['val']) >= {'vehicle_iou', 'panoptic_pq'}
    # the BEV video at VIS_INTERVAL: a TensorBoard event or the npz fallback
    arts = [f for _, _, files in os.walk(os.path.join(log_dir, 'micro'))
            for f in files if f.startswith('events') or f.endswith('.npz')]
    assert arts

    capsys.readouterr()
    resumed = train.main(['--config-file', cfg_yml, '--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'resuming from checkpoint step 1' in printed
    assert 'epoch 0 step' not in printed
    # checkpoint 1 (one epoch) holds the trainer's 3 optimizer steps
    assert resumed['trainer'].step == out['trainer'].step == 3


def test_train_with_lidar_pillar8x(env, capsys):
    write_cfg, log_dir = env
    out = train.main(['--config-file', write_cfg('micro_lidar', lidar=True),
                      '--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'loss' in printed and 'val vehicle_iou=' in printed
    assert out['trainer'].module.model.use_lidar
    assert _checkpoint_steps(out['checkpoint_dir']) == ['1']


@pytest.mark.parametrize('cli,extra', [
    (evaluate, []),
    (evaluate_streaming, ['--eval-interval', '1']),
    (evaluate_streaming, ['--eval-interval', '2']),
    (evaluate_datastream, ['--frame-skip', '10'])],
    ids=['evaluate', 'streaming1', 'streaming2', 'datastream'])
def test_eval_clis_print_the_metric_keys(trained, cli, extra, capsys):
    _, out = trained
    results = cli.main(['--checkpoint', out['checkpoint_dir'],
                        '--device', 'cpu', *extra])
    printed = capsys.readouterr().out
    for key in METRIC_KEYS:
        assert key in printed, key
    assert results['iou'].shape == (2,)
    assert len(results['forward_s']) == 3


def _printed(text, key):
    line = next(ln for ln in text.splitlines() if ln.startswith(key))
    return np.array([float(v) for v in
                     re.findall(r'[-+]?\d*\.?\d+(?:e[-+]?\d+)?',
                                line[len(key):])])


def _seg_panels(plot_dir, h, w):
    """The predicted-vehicle masks of visualise_output's top-left panels."""
    masks = []
    for path in sorted(glob.glob(os.path.join(plot_dir, '*.png'))):
        rgb = np.asarray(Image.open(path))[:h, :w]
        masks.append((rgb == [31, 119, 180]).all(-1)[1:-1, 1:-1])
    return np.stack(masks)


def test_jax_weights_give_the_jax_evaluate(env, tmp_path, monkeypatch,
                                           capsys):
    import evaluate as jax_evaluate
    write_cfg, _ = env
    jcfg = jload_cfg(write_cfg('jax_weights'))
    module = JT.StreamingFlowTrainModule(jcfg)
    variables = init_jax(module, **JT.batch_to_model_args(
        jnp_tree(make_batch(jcfg, 1, seed=0, n_points=64)), jcfg), seed=3)
    # the optimizer chain of JT.create_train_state, whose state the JAX
    # evaluate restores into
    tx = optax.chain(optax.clip_by_global_norm(jcfg.GRAD_NORM_CLIP),
                     optax.add_decayed_weights(jcfg.OPTIMIZER.WEIGHT_DECAY),
                     optax.adam(jcfg.OPTIMIZER.LR))
    state = JT.TrainState.create(
        apply_fn=module.apply, params=variables['params'], tx=tx,
        batch_stats=variables['batch_stats'])
    jdir = str(tmp_path / 'orbax')
    jckpt = JCheckpointManager(jdir)
    jckpt.save(1, state, jcfg)

    monkeypatch.setattr(sys, 'argv', [
        'evaluate.py', '--checkpoint', jdir, '--plot', str(tmp_path / 'jp')])
    jax_evaluate.main()
    want = capsys.readouterr().out

    pdir = str(tmp_path / 'port')
    save_flax_variables_as_checkpoint(
        jckpt.restore_raw(), PConfig().merge_dict(jckpt.load_cfg().to_dict()),
        pdir, jckpt.latest_step())
    evaluate.main(['--checkpoint', pdir, '--device', 'cpu',
                   '--plot', str(tmp_path / 'pp')])
    got = capsys.readouterr().out

    for key in ('vehicle IoU:', 'pq:'):
        w, g = _printed(want, key), _printed(got, key)
        assert w.shape == g.shape == (2,)
        assert np.abs(g - w).max() <= 0.01, (key, g, w)
    assert _printed(want, 'vehicle IoU:')[1] > 0
    jm = _seg_panels(str(tmp_path / 'jp'), 64, 64)
    pm = _seg_panels(str(tmp_path / 'pp'), 64, 64)
    assert jm.shape == pm.shape and jm.shape[0] >= 9
    assert jm.any() and (~jm).any()
    assert (jm == pm).mean() >= 0.999


@pytest.mark.parametrize('cli', [train, evaluate, evaluate_streaming,
                                 evaluate_datastream],
                         ids=['train', 'evaluate', 'streaming',
                              'datastream'])
def test_cli_without_device_needs_cuda(trained, cli, monkeypatch):
    _, out = trained
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = (['--config-file', trained[0]] if cli is train
            else ['--checkpoint', out['checkpoint_dir']])
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(argv)
