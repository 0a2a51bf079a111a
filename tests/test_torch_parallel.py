"""Data-parallel training of the port (streamingflow_tpu_torch/parallel/)
on two gloo ranks on the CPU.

One module-scoped fixture spawns the two ranks once
(``parallel.launch.spawn_ranks``: a FileStore rendezvous in a temporary
directory, so xdist workers cannot collide on a port, and a timeout on the
group and on the join, so a dead rank fails the test in seconds).  What the
ranks compute is in tests/torch_dp_ranks.py; the JAX side and the
one-process steps run here, on the same numpy inputs.

(a) The modules that couple samples, over two ranks, against the JAX
    package on the global batch in fp32 at 1e-5: ``BatchNorm`` against flax
    ``nn.BatchNorm`` in train mode (output, new running statistics; also
    one value per channel on a rank), ``MaskedBatchNorm`` against JAX's
    (unequal active counts; one rank holding none),
    ``spatial_regression_loss`` and ``compute_losses`` (one rank's offset
    and flow all masked).  Each rank's loss is the rank's part of the
    global loss, scaled so that the mean over the ranks is the global loss:
    the test holds that mean.
(b) Whole steps: the data-parallel step over two ranks against the port's
    own one-process step on the same global batch of 2, fp64, at 1e-9 of
    each leaf's scale (the scale floored at the median leaf's, where a
    leaf's gradient is zero but for rounding): losses, gradients,
    parameters, Adam's state, running statistics and ``diag/*``, with
    PROBABILISTIC, dropout and drop-connect on, on the tiny pillar8x and
    the micro spconv8x configurations.  The one-process step is held
    against JAX by tests/test_torch_train_step.py and
    test_torch_train_spconv.py.  Both ranks end with the same state, bit
    for bit.
(c) parallel/collect.py: the gather in rank order, the sums, and the IoU
    state summed over the ranks equal to the JAX package's
    ``combine_metrics`` on the same data.
(d) make_mesh's divisor rule and the world-1 identities, with no
    processes.
(e) ``tools/dryrun_multichip.py 2 --device cpu``, once.
Besides: the launcher raises a failed rank's error at once and kills
ranks past its timeout; the ranks skip together a training batch in which
one lost an invalid item (``parallel.complete_batches``); the loader's
shards cover a split once; and the evaluation forward's noise is a batch's
own (the JAX package's PRNGKey(0) per call), so a shard of a batch
forecasts as that batch's rows do.
"""
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import tiny_config as jax_tiny_config
from streamingflow_tpu.models.lidar_encoder import \
    MaskedBatchNorm as JaxMaskedBatchNorm
from streamingflow_tpu.parallel import combine_metrics as jax_combine
from streamingflow_tpu.training import losses as JL
from streamingflow_tpu.training import metrics as JM
from streamingflow_tpu.training.trainer import \
    compute_losses as jax_compute_losses
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.data import make_batch
from streamingflow_tpu_torch.data.dataloader import (DataLoader,
                                                     EpochBatchSampler)
from streamingflow_tpu_torch.layers.trainmode import BatchShard
from streamingflow_tpu_torch.parallel import (
    DataGroup, combine_metrics, complete_batches, gather_across_processes,
    make_mesh,
    participants, shard_batch, sum_across_processes)
from streamingflow_tpu_torch.parallel.launch import spawn_ranks
from streamingflow_tpu_torch.tools import dryrun_multichip
from streamingflow_tpu_torch.training.metrics import IntersectionOverUnion

import torch_dp_ranks as R
from torch_parity import assert_close


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The two ranks' results and, computed meanwhile here, the
    one-process steps of both configurations, plain and through the
    ranks' global-moments path."""
    shared = str(tmp_path_factory.mktemp('checkpoints'))
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn_ranks, R.rank_work, R.WORLD, shared,
                          timeout_s=240.0)
        single = {b: R.run_step(R.step_cfg(b)) for b in R.STEP_BACKBONES}
        moments = {b: R.moments_step(b) for b in R.STEP_BACKBONES}
        out = job.result()
    assert [o['rank'] for o in out] == [0, 1]
    return out, single, moments


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize('case', sorted(R.BN_CASES))
def test_batch_norm_over_two_ranks_matches_flax(ranks, case):
    out, _, _ = ranks
    x, scale, bias, mean, var = R.bn_inputs(case)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    want, upd = bn.apply(
        {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {'mean': mean, 'var': var}},
        jnp.asarray(np.moveaxis(x, 1, -1)), mutable=['batch_stats'])
    got = np.concatenate([o['bn'][case][0] for o in out])
    assert_close(got, np.moveaxis(np.asarray(want), -1, 1), 1e-5, 'output')
    for o in out:
        assert_close(o['bn'][case][1], upd['batch_stats']['mean'], 1e-5,
                     'running mean')
        assert_close(o['bn'][case][2], upd['batch_stats']['var'], 1e-5,
                     'running var')


@pytest.mark.parametrize('case', R.MASKED_CASES)
def test_masked_batch_norm_over_two_ranks_matches_jax(ranks, case):
    out, _, _ = ranks
    x, mask, scale, bias = R.masked_inputs(case)
    c = scale.shape[0]
    want, upd = JaxMaskedBatchNorm().apply(
        {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {'mean': np.zeros(c, np.float32),
                         'var': np.ones(c, np.float32)}},
        jnp.asarray(x), jnp.asarray(mask), train=True,
        mutable=['batch_stats'])
    got = np.concatenate([o['masked'][case][0] for o in out])
    assert_close(got, np.asarray(want), 1e-5, 'output')
    for o in out:
        assert_close(o['masked'][case][1], upd['batch_stats']['mean'], 1e-5,
                     'running mean')
        assert_close(o['masked'][case][2], upd['batch_stats']['var'], 1e-5,
                     'running var')


def test_spatial_regression_loss_takes_the_global_count(ranks):
    out, _, _ = ranks
    pred, target = R.regression_inputs()
    for norm in (1, 2):
        want = float(JL.spatial_regression_loss(
            jnp.asarray(pred), jnp.asarray(target), norm=norm, n_present=2,
            future_discount=0.9))
        got = np.mean([o['regression'][norm] for o in out])
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=norm)
    # rank 1 holds only masked rows: its part is zero, rank 0's carries all
    assert out[1]['regression'][1] == 0.0


def test_compute_losses_over_two_ranks_match_jax(ranks):
    out, _, _ = ranks
    cfg = R.loss_cfg()
    o, labels, weights = R.loss_inputs(cfg)
    want = jax_compute_losses(
        {k: jnp.asarray(v) for k, v in o.items()},
        {k: jnp.asarray(v) for k, v in labels.items()},
        {k: jnp.asarray(v) for k, v in weights.items()}, jax_tiny_config())
    assert set(out[0]['losses']) == set(want)
    for k, w in want.items():
        got = np.mean([r['losses'][k] for r in out])
        np.testing.assert_allclose(got, float(w), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------- (b)
def _leaves_close(got, want, tol, what):
    floor = float(np.median([np.abs(w).max() for w in want.values()]))
    assert set(got) == set(want), what
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[k].astype(np.float64) - w).max())
        assert err <= tol * scale, (what, k, err, scale)


def _params_close(got, want, lr, tol):
    """Parameters after Adam's first step, lr g / (|g| + eps) with g the
    gradient plus the weight decay: 1e-9 of the leaf's scale, plus what the
    two steps' gradient difference (held to 1e-9 above) moves that update
    by, lr eps |dg| / (|g| + eps)^2 (twice, for the second order), which is
    large where |g| is near Adam's eps."""
    eps = 1e-8
    floor = float(np.median([np.abs(w).max() for w in want['grads'].values()
                             ]))
    for k, g in want['grads'].items():
        p, w = got['state'][k], want['state'][k]
        dg = np.abs(got['grads'][k] - g)
        allowed = (tol * max(float(np.abs(w).max()), floor)
                   + 2 * lr * eps * dg / (np.abs(g) + eps) ** 2)
        worst = np.max(np.abs(p - w) - allowed)
        assert worst <= 0, ('parameter', k, worst)


@pytest.mark.parametrize('backbone', R.STEP_BACKBONES)
def test_two_rank_step_equals_the_one_process_step(ranks, backbone):
    out, single, _ = ranks
    want = single[backbone]
    for o in out:
        got = o['steps'][backbone]
        assert set(got['metrics']) == set(want['metrics'])
        for k, w in want['metrics'].items():
            if k.startswith('diag/'):
                assert int(got['metrics'][k]) == int(w), k
            else:
                np.testing.assert_allclose(got['metrics'][k], w, rtol=1e-9,
                                           atol=1e-12, err_msg=k)
        _leaves_close(got['grads'], want['grads'], 1e-9, 'gradient')
        _leaves_close(got['adam'], want['adam'], 1e-9, 'adam')
        buffers = [k for k in want['state'] if k not in want['grads']
                   and 'num_batches' not in k]
        _leaves_close({k: got['state'][k] for k in buffers},
                      {k: want['state'][k] for k in buffers}, 1e-9,
                      'running statistics')
        _params_close(got, want, R.step_cfg(backbone).OPTIMIZER.LR, 1e-9)
    if backbone == 'spconv8x':
        assert {k for k in want['metrics'] if k.startswith('diag/')}
    # the ranks end in one state, bit for bit
    for k, v in out[0]['steps'][backbone]['state'].items():
        assert np.array_equal(v, out[1]['steps'][backbone]['state'][k]), k


@pytest.mark.parametrize('backbone', R.STEP_BACKBONES)
def test_the_moments_leg_is_the_one_process_step(ranks, backbone):
    """chip_smoke.py's 'moments' leg, in fp64: the one-process step
    through the ranks' global-moments path over a group of one equals the
    one-process step (1e-9 of each leaf's scale), so that on the card it
    differs from it by rounding alone."""
    _, single, moments = ranks
    want, got = single[backbone], moments[backbone]
    for k, w in want['metrics'].items():
        np.testing.assert_allclose(got['metrics'][k], w, rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    _leaves_close(got['grads'], want['grads'], 1e-9, 'gradient')


def test_checkpoint_written_by_rank0_restored_by_broadcast(ranks):
    """Rank 0 writes, every rank finds the step once the save returns
    (the barrier), and a restore that only rank 0 can read gives every
    rank the saved state, Adam's and the step count included."""
    out, _, _ = ranks
    for o in out:
        c = o['checkpoint']
        assert c['found'] == ['1', 'config.json'], c['found']
        assert c['same'] and c['same_adam'] and c['step'] == 1


# ---------------------------------------------------------------- (c)
def test_gather_and_sums_across_ranks(ranks):
    out, _, _ = ranks
    locals_ = [R.collect_inputs(r)[0] for r in range(R.WORLD)]
    for o in out:
        c = o['collect']
        np.testing.assert_array_equal(c['gathered'], np.stack(locals_))
        np.testing.assert_array_equal(c['summed'], sum(locals_))
        np.testing.assert_array_equal(c['tree']['a'], sum(locals_))
        np.testing.assert_array_equal(c['tree']['b'][0], 2 * sum(locals_))


def test_summed_metric_states_equal_jax_combine_metrics(ranks):
    out, _, _ = ranks
    jax_metrics, port_metrics = [], []
    for r in range(R.WORLD):
        _, pred, target = R.collect_inputs(r)
        jm = JM.IntersectionOverUnion(2)
        jm.update(pred, target)
        jax_metrics.append(jm)
        pm = IntersectionOverUnion(2)
        pm.update(pred, target)
        port_metrics.append(pm)
    want = np.asarray(jax_combine(jax_metrics).state())
    for o in out:
        np.testing.assert_array_equal(o['collect']['iou_state'], want)
    np.testing.assert_array_equal(combine_metrics(port_metrics).state(),
                                  want)


# ---------------------------------------------------------------- (d)
@pytest.mark.parametrize('batch,world,want', [
    (1, 2, 1), (2, 2, 2), (3, 2, 1), (6, 4, 3), (8, 8, 8), (12, 8, 6)])
def test_make_mesh_takes_the_largest_divisor(batch, world, want):
    assert participants(batch, world) == want


def test_world_one_is_the_identity():
    group = make_mesh(4, device='cpu')
    assert (group.world, group.pg, group.active, group.is_main) == \
        (1, None, True, True)
    local = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(gather_across_processes(local, group),
                                  local[None])
    np.testing.assert_array_equal(sum_across_processes(local, group), local)
    batch = {'a': np.arange(4), 'b': 'x'}
    assert shard_batch(batch, group)['a'].tolist() == [0, 1, 2, 3]
    rank1 = DataGroup(1, 2, None, torch.device('cpu'))
    assert shard_batch(batch, rank1)['a'].tolist() == [2, 3]
    with pytest.raises(ValueError):
        shard_batch({'a': np.arange(3)}, rank1)


# ---------------------------------------------------------------- (e)
def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip.main(['2', '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(' [')[1].split(']')[0] for ln in lines
            if ln.startswith('dryrun_multichip(2) ok')] == \
        ['spconv8x/column', 'pillar8x']


# ------------------------------------------------------- launcher
def test_spawn_ranks_raises_the_failed_ranks_error():
    """A rank that raises ends the run at once with its error, the other
    rank (waiting for it in a collective) killed.  The other rank's own
    failure in the collective may reach the launcher first; the failed
    rank's error is raised all the same."""
    with pytest.raises(RuntimeError, match='(?s)rank 1:.*planted failure'):
        spawn_ranks(R.fail_on_rank1, 2, timeout_s=60.0)


def test_spawn_ranks_kills_ranks_past_the_timeout():
    with pytest.raises(TimeoutError, match=r'ranks \[0, 1\]'):
        spawn_ranks(R.sleep_long, 2, timeout_s=6.0)


# ------------------------------------------------------- loader, eval noise
def test_ranks_skip_a_global_batch_together(ranks):
    """Training: a global batch in which a rank lost an invalid item
    (batch 0: rank 1 holds one row of two) or all its items (batch 1: rank
    0 holds none) is skipped on every rank, not stepped on a short shard
    nor left to one rank; batch 2 steps on both.  Validation's plain
    iteration keeps the short shard without its batch_shard, and a rank
    with no valid item has no batch."""
    out, _, _ = ranks
    assert out[0]['complete']['stepped'] == [None, None, [8, 9]]
    assert out[1]['complete']['stepped'] == [None, None, [10, 11]]
    assert out[0]['complete']['plain'] == [([0, 1], (0, 2, 4)),
                                           ([8, 9], (0, 2, 4))]
    assert out[1]['complete']['plain'] == [([2], None), ([6, 7], (2, 2, 4)),
                                           ([10, 11], (2, 2, 4))]
    # world 1: the loader's batches, invalid items dropped, as before
    single = DataLoader(R.loader_items(), 4, shuffle=False)
    one = complete_batches(single, make_mesh(4, device='cpu'))
    assert [b['index'].tolist() for b in one] == \
        [[0, 1, 2], [6, 7], [8, 9, 10, 11]]


@pytest.mark.parametrize('n,batch,shuffle,drop_last', [
    (7, 2, True, False), (9, 4, False, False), (8, 4, True, True)])
def test_loader_shards_cover_the_split_once(n, batch, shuffle, drop_last):
    """The ranks' rows of each global batch, in order, are the one-process
    loader's batch: no item repeated, none left out."""
    single = list(EpochBatchSampler(n, batch, shuffle, drop_last, seed=3))
    shards = [EpochBatchSampler(n, batch, shuffle, drop_last, 3, r, 2)
              .shards() for r in range(2)]
    merged = [[] for _ in single]
    for r, per_rank in enumerate(shards):
        k = 0
        for b, want in enumerate(single):
            lo = min(r * (batch // 2), len(want))
            hi = min(lo + batch // 2, len(want))
            if hi > lo:
                ix, meta = per_rank[k]
                assert ix == want[lo:hi] and meta == (lo, hi - lo, len(want))
                merged[b] += ix
                k += 1
        assert k == len(per_rank)
    assert merged == single


def test_eval_forward_noise_is_the_batchs_own():
    """With PROBABILISTIC on, eval_forward draws from a generator seeded 0
    each call (the JAX package's PRNGKey(0)): the same batch twice gives
    the same forecast, and a shard of rows (1, 1, 2) forecasts as row 1 of
    the whole batch, not as the row alone does (fp64: the noise moves the
    random-weight forecast by ~1e-6 only)."""
    cfg = R.step_cfg('pillar8x')
    trainer = P.build_trainer(cfg, device='cpu', seed=0)
    trainer.module.to(torch.float64)
    batch = make_batch(cfg, 2, seed=5, n_points=512)
    batch['image'] = batch['image'].astype(np.float64)
    row1 = {k: v[1:] for k, v in batch.items()}
    first = P.eval_forward(trainer, batch)
    again = P.eval_forward(trainer, batch)
    row = P.eval_forward(trainer, row1, shard=BatchShard(1, 1, 2))
    alone = P.eval_forward(trainer, row1)
    for k in ('segmentation', 'instance_offset', 'instance_flow'):
        assert torch.equal(first[k], again[k]), k
        torch.testing.assert_close(row[k], first[k][1:], rtol=0, atol=1e-12)
        assert (alone[k] - first[k][1:]).abs().max() > 1e-9, k
