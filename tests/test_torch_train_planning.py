"""The train module with PLANNING.ENABLED: the port's forward and
``compute_losses`` against the JAX ``StreamingFlowTrainModule.apply`` with
``planning_inputs`` (train mode) and the JAX ``compute_losses``, at
``tiny_config`` (camera, 9 candidates, GRU state 16), the same random
variables carried across by the bridge, the same make_batch.

Only the JAX *forward* is compiled (the JAX step with planning compiles for
about six minutes, tests/test_planning.py:164-167).  Dropout and
drop-connect are neutralised on both sides, as in
tests/test_torch_train_step.py, whose bars these are: every loss, the
planning terms included, 1e-3 relative in fp32 and 1e-6 in fp64.  One
exception in fp32: the JAX fp32 forward's planning loss lies 2.0e-3 from
its own fp64 loss (the port's fp32 loss 1.8e-4 from its fp64 one; the cost
volume enters it times 100), so the port's fp32 planning loss is held to
the JAX fp64 loss at 1e-3 and to the JAX fp32 loss at 5e-3.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.models import efficientnet as jeff
from streamingflow_tpu.training import trainer as JT
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import load_flax_variables, state_to_flax
from streamingflow_tpu_torch.layers.trainmode import Dropout
from streamingflow_tpu_torch.training import trainer as PT

from torch_parity import init_jax, jnp_tree, port_like


def _cfg():
    cfg = tiny_config()
    cfg.PROBABILISTIC.ENABLED = False
    cfg.MODEL.BEV_POOL_BACKEND = 'scatter'
    cfg.PLANNING.ENABLED = True
    cfg.PLANNING.SAMPLE_NUM = 9
    cfg.PLANNING.GRU_STATE_SIZE = 16
    return cfg


def _batch(cfg):
    batch = make_batch(cfg, 1, seed=5, n_points=256)
    # candidates that reach the occupied cells and a goal point
    rng = np.random.RandomState(8)
    batch['sample_trajectory'] = np.cumsum(rng.uniform(
        -1.0, 2.0, batch['sample_trajectory'].shape), axis=2).astype(
        np.float32)
    return batch


def _jax_forward(x64):
    """The JAX train module's train-mode forward with planning inputs and
    its loss dict, on random variables."""
    patch = pytest.MonkeyPatch()
    patch.setattr(flax.linen.Dropout, '__call__',
                  lambda self, inputs, deterministic=None, rng=None: inputs)
    patch.setattr(jeff, '_DROP_CONNECT_RATE', 0.0)
    try:
        cfg = _cfg()
        batch = _batch(cfg)
        module = JT.StreamingFlowTrainModule(cfg)
        jb = jnp_tree(batch)
        labels = JT.prepare_future_labels(jb, cfg)
        variables = init_jax(module, like=port_like(cfg, train=True))
        key = jax.random.PRNGKey(0)

        def fwd(params, stats, jbatch):
            labels = JT.prepare_future_labels(jbatch, cfg)
            (output, weights), _ = module.apply(
                {'params': params, 'batch_stats': stats},
                **JT.batch_to_model_args(jbatch, cfg),
                planning_inputs=JT.build_planning_inputs(jbatch, labels, cfg),
                train=True, rngs={'dropout': key, 'sample': key},
                mutable=['batch_stats', 'diagnostics'])
            losses = JT.compute_losses(output, labels, weights, cfg)
            return losses, output['selected_traj']

        with jax.enable_x64(x64), jax.default_matmul_precision('highest'):
            jbatch = jnp_tree(batch)
            params, stats = variables['params'], variables['batch_stats']
            if x64:
                jbatch['image'] = jnp.asarray(batch['image'], jnp.float64)
                params, stats = jax.tree.map(
                    lambda a: jnp.asarray(a, jnp.float64), (params, stats))
            losses, traj = jax.tree.map(np.asarray, jax.jit(fwd)(
                params, stats, jbatch))
        return cfg, batch, variables, losses, traj
    finally:
        patch.undo()


def _port_trainer(cfg, variables, double):
    pcfg = PConfig().merge_dict(cfg.to_dict())
    trainer = P.build_trainer(pcfg, device='cpu')
    load_flax_variables(trainer.module, variables)
    if double:
        trainer.module.double()
    for m in trainer.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return pcfg, trainer


def _port_losses(cfg, batch, trainer):
    module = trainer.module.train()
    labels = PT.prepare_future_labels(
        {k: PT.to_tensor(batch[k], 'cpu') for k in PT.LABEL_KEYS
         if k in batch}, cfg)
    args = PT.batch_to_model_args(
        batch, cfg, device='cpu',
        image_dtype=next(module.parameters()).dtype)
    output, weights = module(
        **args, planning_inputs=PT.build_planning_inputs(batch, labels, cfg))
    return PT.compute_losses(output, labels, weights, cfg), output


@pytest.fixture(scope='module')
def jax_forwards():
    return {x64: _jax_forward(x64) for x64 in (False, True)}


@pytest.mark.parametrize('x64,tol', [(False, 1e-3), (True, 1e-6)])
def test_losses_with_planning_match_jax(jax_forwards, x64, tol):
    cfg, batch, variables, want, want_traj = jax_forwards[x64]
    pcfg, trainer = _port_trainer(cfg, variables, x64)
    losses, output = _port_losses(pcfg, batch, trainer)
    assert {'planning', 'planning_uncertainty'} <= set(want)
    assert set(losses) == set(want)
    for k, w in want.items():
        if k == 'planning' and not x64:
            np.testing.assert_allclose(float(losses[k].detach()), float(w),
                                       rtol=5 * tol, err_msg=k)
            w = jax_forwards[True][3][k]
        np.testing.assert_allclose(float(losses[k].detach()), float(w),
                                   rtol=tol, atol=tol * 1e-2, err_msg=k)
    assert float(want['planning']) > 0
    np.testing.assert_allclose(output['selected_traj'].detach().numpy(),
                               want_traj, rtol=tol, atol=tol * 1e-2)
    assert output['selected_traj'].shape == (1, cfg.N_FUTURE_FRAMES + 1, 3)


def test_train_step_moves_the_planning_parameters():
    """One port train_step: the planning terms are in its metrics, the
    planner's parameters and BN statistics move, and the costvolume head
    (trained through the cost volume's gradient alone) has a gradient."""
    cfg = PConfig().merge_dict(_cfg().to_dict())
    trainer = P.build_trainer(cfg, device='cpu', seed=0)
    before = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    metrics = P.train_step(trainer, _batch(cfg),
                           generator=torch.Generator().manual_seed(0))
    assert {'planning', 'planning_uncertainty'} <= set(metrics)
    assert torch.isfinite(metrics['planning']) and metrics['planning'] > 0
    planning = [k for k in before if '.planning.' in k
                and 'num_batches' not in k]
    assert len(planning) > 40
    moved = [k for k in planning
             if not torch.equal(before[k], trainer.module.state_dict()[k])]
    assert moved == planning
    grads = state_to_flax(trainer.module, grads=True)['params']
    head = [k for k in grads if 'costvolume_head' in k]
    assert head and all(np.abs(grads[k]).max() > 0 for k in head)


def test_eval_forward_with_planning_inputs():
    """``eval_forward`` passes planning inputs to the planner in eval mode:
    a selected trajectory, the origin first, and a zero loss; without them
    the planner does not run."""
    cfg = PConfig().merge_dict(_cfg().to_dict())
    trainer = P.build_trainer(cfg, device='cpu', seed=0)
    batch = _batch(cfg)
    labels = PT.prepare_future_labels(
        {k: PT.to_tensor(batch[k], 'cpu') for k in PT.LABEL_KEYS
         if k in batch}, cfg)
    out = P.eval_forward(trainer, batch, planning_inputs=PT.
                         build_planning_inputs(batch, labels, cfg))
    traj = out['selected_traj']
    assert traj.shape == (1, cfg.N_FUTURE_FRAMES + 1, 3)
    assert float(traj[:, 0].abs().max()) == 0.0 and torch.isfinite(traj).all()
    assert float(out['planning_loss']) == 0.0
    assert 'selected_traj' not in P.eval_forward(trainer, batch)
