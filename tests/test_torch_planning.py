"""The planning head: streamingflow_tpu_torch/models/planning.py against
streamingflow_tpu/models/planning.py, the JAX variables carried across by
the port's bridge, on the shapes of tests/test_planning.py:128-161
(B 2, 9 candidates, a (2, 8, 16, 16) front-camera feature, 32 x 32 maps).

Bars: fp32 outputs and losses 1e-5 of their scale; in fp64 the gradient of
the loss for every planning parameter and for the cost volume 1e-6 of each
leaf's scale, against ``jax.grad``.  The selected candidates are compared
where the JAX costs leave no near tie (none is excluded at these inputs:
the test asserts the margin).
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import tiny_config as jax_tiny_config
from streamingflow_tpu.models import planning as JP
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.config import Config
from streamingflow_tpu_torch.convert import (flatten, load_flax_variables,
                                             state_to_flax)
from streamingflow_tpu_torch.data import tiny_config
from streamingflow_tpu_torch.models import planning as PP

from torch_parity import apply_jax, assert_close, init_jax, t


def _cfgs():
    cfgs = []
    for make in (jax_tiny_config, tiny_config):
        cfg = make()
        cfg.PLANNING.ENABLED = True
        cfg.PLANNING.SAMPLE_NUM = 9
        cfg.PLANNING.GRU_STATE_SIZE = 16
        cfgs.append(cfg)
    return cfgs


def _args(seed=0, hd_channels=2, cam_hw=(8, 16), commands=(0, 2)):
    rng = np.random.RandomState(seed)
    B, N, T, H, W = 2, 9, 2, 32, 32
    hd = (rng.rand(B, 2, H, W) > 0.5) if hd_channels == 2 else \
        rng.randn(B, 4, H, W)
    return dict(
        cam_front=rng.rand(B, *cam_hw, 16).astype(np.float32),
        trajs=rng.randn(B, N, T, 3).astype(np.float32),
        gt_trajs=rng.randn(B, T, 3).astype(np.float32),
        cost_volume=rng.rand(B, T, H, W).astype(np.float32),
        semantic_pred=(rng.rand(B, T, H, W) > 0.9).astype(np.float32),
        hd_map=hd.astype(np.float32),
        commands=np.asarray(commands, np.int32),
        target_points=rng.randn(B, 2).astype(np.float32))


def _modules(cam_hw=(8, 16)):
    jcfg, pcfg = _cfgs()
    return (JP.Planning(cfg=jcfg, feature_channel=16, gru_state_size=16),
            PP.Planning(pcfg, 16, 16, feature_hw=cam_hw))


@pytest.mark.parametrize('commands', [(0, 1, 2, 3), (3, 3, 1, 0)])
def test_select_command_trajs_matches_jax(commands):
    rng = np.random.RandomState(4)
    trajs = rng.randn(4, 12, 3, 3).astype(np.float32)
    cmds = np.asarray(commands, np.int32)
    want = JP.select_command_trajs(jnp.asarray(trajs), jnp.asarray(cmds), 4)
    got = PP.select_command_trajs(t(trajs), t(cmds), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('hd_channels', [2, 4])
@pytest.mark.parametrize('train', [True, False])
def test_planning_matches_jax(train, hd_channels):
    jm, pm = _modules()
    args = _args(hd_channels=hd_channels)
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    variables = init_jax(jm, **jargs, train=True)
    if train:
        (loss, traj), upd = apply_jax(jm, variables, **jargs, train=True,
                                      mutable=['batch_stats'])
    else:
        loss, traj = apply_jax(jm, variables, **jargs, train=False)
    load_flax_variables(pm, variables)
    pm.train(train)
    ploss, ptraj = pm(**{k: t(v) for k, v in args.items()})
    assert_close(ptraj, traj, 1e-5, 'output_traj')
    assert_close(ploss, loss, 1e-5, 'loss')
    if train:
        assert float(loss) > 0
        stats = state_to_flax(pm)['batch_stats']
        for k, w in flatten(upd['batch_stats']).items():
            assert_close(stats[k], w, 1e-5, k)
    else:
        assert float(loss) == 0.0 == float(ploss)


def test_costs_and_selection_match_jax():
    """The candidates' costs, and the selected candidate where the best
    leads the runner-up by more than the costs' bar."""
    jm, pm = _modules()
    args = _args(seed=1)
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    variables = init_jax(jm, **jargs, train=False)
    cur = JP.select_command_trajs(jargs['trajs'], jargs['commands'], 3)
    maps = (jargs['cost_volume'], jargs['semantic_pred'],
            jargs['hd_map'][:, :1], jargs['hd_map'][:, 1:],
            jargs['target_points'])
    fc, fo = jm.apply(variables, cur, *maps, method=jm._costs)
    want = jm.apply(variables, cur, *maps, method=jm.select)
    load_flax_variables(pm, variables)
    pcur = PP.select_command_trajs(t(args['trajs']), t(args['commands']), 3)
    pmaps = [t(np.asarray(m)) for m in maps]
    pfc, pfo = pm.costs(pcur, *pmaps)
    assert_close(pfc, np.asarray(fc), 1e-5, 'cost_fc')
    assert_close(pfo, np.asarray(fo), 1e-5, 'cost_fo')
    total = np.sort(np.asarray(fc + fo.sum(-1)), axis=1)
    # every candidate appears 3 times: the runner-up is the next distinct
    lead = np.array([next(v - row[0] for v in row if v > row[0])
                     for row in total])
    assert (lead > 1e-5 * np.abs(total).max()).all(), lead
    np.testing.assert_array_equal(
        PP.Planning.select(pcur, (pfc, pfo)).numpy(), np.asarray(want))


def test_planning_gradients_match_jax_in_float64():
    """The loss's gradient for every planning parameter and for the cost
    volume (which reaches the decoder's costvolume head in training), fp64,
    1e-6 of each leaf's scale.  The max over candidates meets each one
    three times: its gradient splits evenly, as JAX's reduce-max does."""
    jm, pm = _modules()
    args = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in _args(seed=2).items()}
    with jax.enable_x64(True):
        jargs = {k: jnp.asarray(v) for k, v in args.items()}
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 init_jax(jm, **jargs, train=True))

        def loss_fn(params, cv):
            (loss, _), _ = jm.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                **{**jargs, 'cost_volume': cv}, train=True,
                mutable=['batch_stats'])
            return loss

        with jax.default_matmul_precision('highest'):
            g_params, g_cv = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(
                variables['params'], jargs['cost_volume'])
        g_params = jax.tree.map(np.asarray, g_params)
        g_cv = np.asarray(g_cv)
    load_flax_variables(pm, variables)
    pm.double().train()
    targs = {k: t(v) for k, v in args.items()}
    targs['cost_volume'].requires_grad_(True)
    loss, _ = pm(**targs)
    loss.backward()
    assert loss.dtype == torch.float64
    grads = state_to_flax(pm, grads=True)['params']
    want = flatten(g_params)
    assert set(grads) == set(want)
    for k, w in want.items():
        assert_close(torch.from_numpy(grads[k]).double(), w, 1e-6, k)
    assert np.abs(g_cv).max() > 0
    assert_close(targs['cost_volume'].grad, g_cv, 1e-6, 'cost_volume')


@pytest.mark.parametrize('cam_hw', [(2, 3), (1, 1), (4, 8), (6, 3)])
def test_reduce_channel_skips_downsampling_at_small_maps(cam_hw):
    """A side below 2 px stops the downsampling (and a bottleneck of equal
    widths becomes an identity residual, without the residual conv)."""
    jm = JP.ReduceChannel(16)
    pm = PP.ReduceChannel(16, cam_hw)
    x = np.random.RandomState(5).rand(2, *cam_hw, 16).astype(np.float32)
    variables = init_jax(jm, jnp.asarray(x), train=False)
    want = apply_jax(jm, variables, jnp.asarray(x), train=False)
    load_flax_variables(pm, variables).eval()
    got = pm(t(x).permute(0, 3, 1, 2))
    assert_close(got.permute(0, 2, 3, 1), want, 1e-5)
    strided = [getattr(pm, f'Bottleneck_{i}').downsample for i in range(4)]
    want_strided, side = [], min(cam_hw)
    for _ in range(3):
        want_strided.append(side >= 2)
        side = (side + 1) // 2 if side >= 2 else side
    assert strided == want_strided + [False]
    with pytest.raises(ValueError, match='built for'):
        pm(torch.zeros(2, 16, cam_hw[0] + 1, cam_hw[1]))


def test_odd_feature_side_extends_the_jax_module(monkeypatch):
    """At the default images' 28 x 60 feature the third step meets a 7 x 15
    map: the JAX module's strided conv gives 4 x 8, its residual's pool
    3 x 7, and it fails.  The port's pool covers the odd side (ceil mode):
    held against the JAX module with its pool padded the same way."""
    x = np.random.RandomState(6).rand(1, 28, 60, 16).astype(np.float32)
    jm = JP.ReduceChannel(16)
    with pytest.raises(TypeError, match='incompatible shapes'):
        init_jax(jm, jnp.asarray(x), train=False)
    pool = flax.linen.max_pool

    def ceil_pool(h, window, strides):
        pad = [(0, h.shape[1] % 2), (0, h.shape[2] % 2)]
        return pool(h, window, strides=strides, padding=pad)

    monkeypatch.setattr(flax.linen, 'max_pool', ceil_pool)
    variables = init_jax(jm, jnp.asarray(x), train=False)
    want = apply_jax(jm, variables, jnp.asarray(x), train=False)
    pm = load_flax_variables(PP.ReduceChannel(16, (28, 60)), variables)
    got = pm.eval()(t(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (1, 2, 4, 8)
    assert_close(got.permute(0, 2, 3, 1), want, 1e-5)


def test_bridge_both_ways():
    jm, pm = _modules()
    args = {k: jnp.asarray(v) for k, v in _args().items()}
    variables = init_jax(jm, **args, train=True)
    load_flax_variables(pm, variables)
    back = state_to_flax(pm)
    for col in ('params', 'batch_stats'):
        want = flatten(variables[col])
        assert set(back[col]) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(back[col][k], w, err_msg=k)
    # six Linear modules under flax's GRU cell names, two without bias
    assert {k for k in back['params'] if k.startswith('gru/')} == {
        f'gru/{g}/{p}' for g in ('ir', 'iz', 'in', 'hr', 'hz', 'hn')
        for p in ('kernel', 'bias')} - {'gru/hr/bias', 'gru/hz/bias'}


def test_the_default_config_builds_and_plans():
    """Config() (PLANNING.ENABLED by default) builds, and its planner runs
    at the default's shapes: a (1, 28, 60, 64) front-camera feature, 600
    candidates, 200 x 200 maps, 4 futures."""
    cfg = Config()
    assert cfg.PLANNING.ENABLED
    model = P.build_model(cfg, device='cpu', seed=0)
    assert isinstance(model.planning, PP.Planning)
    rng = np.random.RandomState(7)
    B, N, T, H = 1, cfg.PLANNING.SAMPLE_NUM, cfg.N_FUTURE_FRAMES, 200
    with torch.no_grad():
        loss, traj = model.planning(
            cam_front=t(rng.rand(B, 28, 60, 64).astype(np.float32)),
            trajs=t(np.cumsum(rng.rand(B, N, T, 3), 2).astype(np.float32)),
            gt_trajs=t(rng.randn(B, T, 3).astype(np.float32)),
            cost_volume=t(rng.rand(B, T, H, H).astype(np.float32)),
            semantic_pred=t((rng.rand(B, T, H, H) > 0.9).astype(np.float32)),
            hd_map=t((rng.rand(B, 2, H, H) > 0.5).astype(np.float32)),
            commands=t(np.array([1])), target_points=t(np.zeros((B, 2))))
    assert tuple(traj.shape) == (B, T, 3) and torch.isfinite(traj).all()
    assert float(loss) == 0.0
