"""Data-parallel training with the planner: two gloo ranks (spawned by
``parallel.launch.spawn_ranks``; the ranks' work is
tests/torch_dp_ranks.py::planning_rank_work) take one fp64 step of the tiny
pillar8x configuration with PLANNING.ENABLED on a global batch of 2, held
to the one-process step on the same batch at 1e-9: losses, gradients,
Adam's moments, running statistics (the planner's bottlenecks' included)
and parameters.  Rank 0's row has a goal point and rank 1's none, so a
rank that took the goal flag (ops/cost.py::progress_cost) over its own rows
would miss the bars.
"""
import numpy as np

from streamingflow_tpu_torch.parallel.launch import spawn_ranks

import torch_dp_ranks as R
from test_torch_parallel import _leaves_close, _params_close


def test_two_rank_planning_step_equals_the_one_process_step():
    cfg = R.planning_step_cfg()
    batch = R.planning_step_batch(cfg)
    assert np.abs(batch['target_point'][0]).sum() >= 0.5
    out = spawn_ranks(R.planning_rank_work, R.WORLD, timeout_s=240.0)
    want = R.run_step(cfg, None, batch)
    assert {'planning', 'planning_uncertainty'} <= set(want['metrics'])
    assert float(want['metrics']['planning']) > 0
    for o in out:
        got = o['step']
        assert set(got['metrics']) == set(want['metrics'])
        for k, w in want['metrics'].items():
            np.testing.assert_allclose(got['metrics'][k], w, rtol=1e-9,
                                       atol=1e-12, err_msg=k)
        _leaves_close(got['grads'], want['grads'], 1e-9, 'gradient')
        _leaves_close(got['adam'], want['adam'], 1e-9, 'adam')
        buffers = [k for k in want['state'] if k not in want['grads']
                   and 'num_batches' not in k]
        assert any('.planning.' in k for k in buffers)
        _leaves_close({k: got['state'][k] for k in buffers},
                      {k: want['state'][k] for k in buffers}, 1e-9,
                      'running statistics')
        _params_close(got, want, cfg.OPTIMIZER.LR, 1e-9)
    for k, v in out[0]['step']['state'].items():
        assert np.array_equal(v, out[1]['step']['state'][k]), k
