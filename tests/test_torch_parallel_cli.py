"""The port's train CLI data-parallel on the CPU: ``python -m
torch.distributed.run --standalone --nproc_per_node 2 -m
streamingflow_tpu_torch.train --dist-backend gloo`` on a tiny
nuScenes-format tree at BATCHSIZE 2 (camera + spconv8x, PROBABILISTIC on)
for one epoch: rank 0 alone prints and writes the checkpoint, and the
validation, sharded over the two ranks without padding, equals
``evaluate`` of that checkpoint in one process at batch 2: the summed
metric states (IoU's true and false positives, false negatives and support,
PQ's IoU sum, true and false positives and false negatives; nonzero even
where the scores of a one-step model are 0, so that a shard dropped or
counted twice shows) within 1e-3 of their largest count, and IoU, PQ, SQ and
RQ within 1e-3 (the evaluation noise is each batch's own, so the shards'
forecasts are the whole batches' rows)."""
import json
import os
import re
import subprocess
import sys

import numpy as np

from streamingflow_tpu_torch import evaluate
from streamingflow_tpu_torch.training.checkpoint import CheckpointManager

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures_nuscenes import make_mini_nuscenes  # noqa: E402
from test_torch_train_spconv import CLI_CFG  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_rank_train_cli_validation_equals_evaluate(tmp_path):
    root = str(tmp_path / 'nusc')
    make_mini_nuscenes(root, n_scenes=2, n_samples=6, n_sweeps_between=1)
    log_dir = tmp_path / 'logs'
    text = (CLI_CFG.format(root=root, log_dir=str(log_dir))
            .replace('BATCHSIZE: 1', 'BATCHSIZE: 2')
            .replace('COLUMN_CAPS: [1, 1, 1, 1]',
                     'COLUMN_CAPS: [512, 768, 512, 256]')
            + 'PROBABILISTIC:\n  ENABLED: True\n')
    path = tmp_path / 'dp.yml'
    path.write_text(text)
    run = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '2', '-m', 'streamingflow_tpu_torch.train',
         '--config-file', str(path), '--device', 'cpu',
         '--dist-backend', 'gloo'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, 'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1'})
    assert run.returncode == 0, run.stderr[-4000:]
    out = run.stdout
    assert 'data-parallel over 2 rank(s): cpu' in out
    steps = re.findall(r'^epoch 0 step \d+ loss', out, re.M)
    val = re.findall(r'^val (.*)$', out, re.M)
    # rank 0 alone prints: one line a step, one validation line
    assert len(steps) == 1 and len(val) == 1, out
    val = {k: float(v) for k, v in (kv.split('=') for kv in val[0].split())}
    states = re.findall(r'^val_states (.*)$', out, re.M)
    assert len(states) == 1, out
    states = json.loads(states[0])

    ckpt_dir = str(log_dir / 'spconv_cap' / 'checkpoints')
    assert CheckpointManager(ckpt_dir).latest_step() == 1
    results = evaluate.main(['--checkpoint', ckpt_dir, '--device', 'cpu',
                             '--batch-size', '2'])
    one = {'vehicle_iou': float(results['iou'][-1]),
           **{f'panoptic_{k}': float(v[-1])
              for k, v in results['pq'].items()}}
    assert set(val) == set(one)
    for k, v in one.items():
        assert abs(val[k] - v) <= 1e-3, (k, val[k], v)
    assert set(states) == set(results['states']) == {'vehicle', 'panoptic'}
    for k, want in results['states'].items():
        want, got = np.asarray(want), np.asarray(states[k])
        assert want.shape == got.shape and want.max() > 0, (k, want)
        assert np.abs(got - want).max() <= 1e-3 * want.max(), (k, got, want)
