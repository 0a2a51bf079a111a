"""The port's CLIs: their setup pins TF32 off and records it, and a rank
that takes no step under ``torch.distributed.run`` exits cleanly.

* Each CLI (``train``, ``evaluate``, ``evaluate_streaming``,
  ``evaluate_datastream``) turns TF32 off for matmuls and cuDNN
  convolutions before any work, whatever the process had, and prints the
  setting in its log; a checkpoint stores the setting of the process that
  wrote it.  (With PyTorch's default, cuDNN runs fp32 convolutions in TF32
  on the card, which moved a one-step model's panoptic counts.)
* Two gloo ranks at ``BATCHSIZE 1``: one rank takes part, the other takes
  no step.  The active rank trains, validates and writes its checkpoint,
  and both ranks exit 0.
"""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from streamingflow_tpu_torch import (evaluate, evaluate_datastream,
                                     evaluate_streaming, train)
from streamingflow_tpu_torch.config import Config
from streamingflow_tpu_torch.training.checkpoint import CheckpointManager

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures_nuscenes import make_mini_nuscenes  # noqa: E402
from test_torch_train_spconv import CLI_CFG  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YML = os.path.join(ROOT, 'configs', 'prediction_lc_ode_variable.yml')
OFF = {'matmul_allow_tf32': False, 'cudnn_allow_tf32': False}


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _logged(out):
    lines = re.findall(r'^tf32 (.*)$', out, re.M)
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize('cli', [evaluate, evaluate_streaming,
                                 evaluate_datastream])
def test_eval_cli_setup_pins_tf32(cli, tf32_on, monkeypatch, capsys):
    """The setup of an evaluation CLI up to its loop (``run_eval`` stands
    in for the loop)."""
    seen = {}

    def loop(cfg, ckpt, **kw):
        seen['flags'] = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
        return {}

    monkeypatch.setattr(cli, 'run_eval', loop)
    cli.main(['--device', 'cpu', '--config-file', YML])
    assert seen['flags'] == (False, False)
    assert _logged(capsys.readouterr().out) == OFF


def test_train_cli_setup_pins_tf32(tf32_on, monkeypatch, capsys):
    seen = {}

    def fit(cfg, dev, group):
        seen['flags'] = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
        return {}

    monkeypatch.setattr(train, '_fit', fit)
    out = train.main(['--device', 'cpu', '--config-file', YML])
    assert seen['flags'] == (False, False)
    assert out['tf32'] == OFF
    assert _logged(capsys.readouterr().out) == OFF


def test_checkpoint_records_tf32(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    manager.write(3, {'model': {'w': torch.zeros(2)}}, Config())
    assert manager.restore_raw(3)['tf32'] == {
        'matmul_allow_tf32': bool(torch.backends.cuda.matmul.allow_tf32),
        'cudnn_allow_tf32': bool(torch.backends.cudnn.allow_tf32)}


def test_rank_without_a_step_exits_cleanly(tmp_path):
    """``torch.distributed.run`` with two gloo ranks at BATCHSIZE 1 (the
    camera-only tiny CLI config): rank 1 takes no step."""
    root = str(tmp_path / 'nusc')
    make_mini_nuscenes(root, n_scenes=2, n_samples=4, n_sweeps_between=1)
    log_dir = tmp_path / 'logs'
    text = CLI_CFG.format(root=root, log_dir=str(log_dir)).replace(
        'USE_LIDAR: True', 'USE_LIDAR: False')
    path = tmp_path / 'one.yml'
    path.write_text(text)
    run = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '2', '-m', 'streamingflow_tpu_torch.train',
         '--config-file', str(path), '--device', 'cpu',
         '--dist-backend', 'gloo'],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, 'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1'})
    assert run.returncode == 0, run.stderr[-4000:]
    out = run.stdout
    assert 'rank 1: a global batch of 1 shards over 1 rank(s); this rank ' \
        'takes no step' in out, out
    assert 'one device: cpu' in out
    assert len(re.findall(r'^val ', out, re.M)) == 1, out
    assert re.search(r'^epoch 0 done in .*checkpoint saved$', out, re.M)
    manager = CheckpointManager(str(log_dir / 'spconv_cap' / 'checkpoints'))
    assert manager.latest_step() == 1
    assert manager.restore_raw()['tf32'] == OFF
