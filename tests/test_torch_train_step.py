"""The training slice as a whole: one optimisation step of the port
(``train_step``) vs the pieces of the JAX package's
``trainer.make_train_step`` at ``tiny_config`` with camera and LiDAR,
ENCODER.OUT_CHANNELS 64, PROBABILISTIC off, the same random variables carried
across by the bridge, the same make_batch.

flax's dropout and drop-connect streams cannot be reproduced in torch, so
both sides run with them neutralised from here (no JAX file changes); the
port's own masks and MODEL.REMAT are tested in test_torch_train_modules.py.

Two runs, because the tiny step's gradient is ill-conditioned in fp32 (batch
1, a few values per channel under batch-statistics BatchNorm, top-k and ReLU
kinks).  ``test_fp32_rounding_moves_the_tiny_steps_gradient`` measures it on
the port alone: the same step with fp32 and with fp64 parameters agrees in
every loss to 1e-5, while the gradient leaves differ by up to 0.07 of a
leaf's scale (median leaf 0.01; the test prints both).  No fp32 run can hold
another to 5e-3 there.

* float64 (``test_train_step_matches_jax_in_float64``): both sides in
  fp64, which removes the rounding noise and leaves the function.  Bars:
  losses 1e-6 relative, every gradient leaf 1e-3 of its scale, new BN
  statistics 1e-6, parameters after the step as Adam's first update allows.
  The JAX step gets its bf16 pillar features computed op by op by the JAX
  package's own ``pillarize``: under jit XLA contracts the z-std epilogue
  differently and a few hundred features land one bf16 step away from the
  op-by-op values (which the port's equal bit for bit); the features carry
  no gradient.
* float32 (``test_train_step_matches_jax``), the step as users run it, both
  pools: losses 1e-3 relative ('pallas_patch' against JAX 'scatter' 2e-3),
  BN statistics 5e-3 (1e-2), gradient norm 10 %, the gradient leaves behind
  the ill-conditioned stack (decoder heads, task weights) 5e-2 (1e-1: they
  measure 2e-2 and 4e-2), the whole gradient's cosine above 0.8 (0.98 and
  0.88), and every parameter within Adam's 2 * lr.
"""
import itertools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.models import efficientnet as jeff
from streamingflow_tpu.models import pillar_encoder as jpe
from streamingflow_tpu.training import trainer as JT
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import (flatten, load_flax_variables,
                                             state_to_flax)
from streamingflow_tpu_torch.layers.trainmode import Dropout
from streamingflow_tpu_torch.ops import patch_pool as PP
from streamingflow_tpu_torch.training import trainer as PT

from torch_parity import assert_close, init_jax, jnp_tree


def _cfg():
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.MODALITY.USE_CAMERA = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.PROBABILISTIC.ENABLED = False
    cfg.MODEL.BEV_POOL_BACKEND = 'scatter'
    return cfg


def _chain(cfg):
    """The optimizer chain of trainer.create_train_state."""
    return optax.chain(optax.clip_by_global_norm(cfg.GRAD_NORM_CLIP),
                       optax.add_decayed_weights(cfg.OPTIMIZER.WEIGHT_DECAY),
                       optax.adam(cfg.OPTIMIZER.LR))


def _eager_pillar_features(cfg, points):
    """The bf16 pillar features of every cloud, by the JAX package's
    ``pillarize`` run op by op, as PillarBEVEncoder calls it."""
    se = cfg.MODEL.SPARSE_ENCODER
    flat = jnp.asarray(points).reshape(-1, *points.shape[2:])
    pmask = jnp.any(flat[..., :3] != 0, axis=-1)
    return [jpe.pillarize(flat[i], pmask[i], se.POINT_CLOUD_RANGE,
                          se.VOXEL_SIZE, 8, out_dtype=jnp.bfloat16,
                          presorted=cfg.MODEL.LIDAR.TILE_SORTED_POINTS,
                          layout='cf') for i in range(flat.shape[0])]


def _jax_step(x64):
    """The body of make_train_step's ``train_step`` on random variables:
    losses, gradients, clipped gradients, new BN statistics, new params.
    ``x64``: variables and images in float64, pillar features op by op."""
    patch = pytest.MonkeyPatch()
    patch.setattr(flax.linen.Dropout, '__call__',
                  lambda self, inputs, deterministic=None, rng=None: inputs)
    patch.setattr(jeff, '_DROP_CONNECT_RATE', 0.0)
    try:
        cfg = _cfg()
        batch = make_batch(cfg, 1, seed=5, n_points=2048)
        module = JT.StreamingFlowTrainModule(cfg)
        variables = init_jax(module, **JT.batch_to_model_args(
            jnp_tree(batch), cfg))
        key = jax.random.PRNGKey(0)
        if x64:
            feats = _eager_pillar_features(cfg, batch['points'])
            calls = itertools.count()
            patch.setattr(jpe, 'pillarize', lambda *a, **kw:
                          feats[next(calls) % len(feats)])

        def step(params, batch_stats, jbatch):
            labels = JT.prepare_future_labels(jbatch, cfg)
            model_args = JT.batch_to_model_args(jbatch, cfg)

            def loss_fn(p):
                (output, weights), updates = module.apply(
                    {'params': p, 'batch_stats': batch_stats}, **model_args,
                    planning_inputs=None, train=True,
                    rngs={'dropout': key, 'sample': key},
                    mutable=['batch_stats', 'diagnostics'])
                loss_dict = JT.compute_losses(output, labels, weights, cfg)
                return sum(loss_dict.values()), (loss_dict, updates)

            (total, (loss_dict, updates)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            tx = _chain(cfg)
            clipped, _ = optax.clip_by_global_norm(
                cfg.GRAD_NORM_CLIP).update(grads, optax.EmptyState())
            upd, _ = tx.update(grads, tx.init(params), params)
            return dict(total=total, losses=loss_dict, grads=grads,
                        clipped=clipped, norm=optax.global_norm(grads),
                        stats=updates['batch_stats'],
                        params=optax.apply_updates(params, upd))

        with jax.enable_x64(x64), jax.default_matmul_precision('highest'):
            jbatch = jnp_tree(batch)
            params, stats = variables['params'], variables['batch_stats']
            if x64:
                jbatch['image'] = jnp.asarray(batch['image'], jnp.float64)
                params, stats = jax.tree.map(
                    lambda a: jnp.asarray(a, jnp.float64), (params, stats))
            out = jax.tree.map(np.asarray,
                               jax.jit(step)(params, stats, jbatch))
        return cfg, batch, variables, out
    finally:
        patch.undo()


@pytest.fixture(scope='module')
def jax_step():
    return _jax_step(x64=False)


@pytest.fixture(scope='module')
def jax_step_x64():
    return _jax_step(x64=True)


def _port_step(cfg, batch, variables, backend, double=False):
    pcfg = PConfig().merge_dict(cfg.to_dict())
    pcfg.MODEL.BEV_POOL_BACKEND = backend
    if double:
        pcfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = 'float64'
    trainer = P.build_trainer(pcfg, device='cpu')
    load_flax_variables(trainer.module, variables)
    if double:
        trainer.module.double()
    for m in trainer.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    before = state_to_flax(trainer.module)['params']
    metrics = P.train_step(trainer, batch)
    return trainer, metrics, before


def _leaf_close(got, want, tol, floor, what):
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), floor)
    assert got.shape == want.shape and err <= tol * scale, (
        f'{what}: max abs err {err:.3g} over scale {scale:.3g} exceeds '
        f'{tol:g}')


def _check_losses(metrics, want, tol):
    assert set(metrics) == set(want['losses']) | {'total_loss', 'grad_norm'}
    for k, w in want['losses'].items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=tol,
                                   atol=tol * 1e-2, err_msg=k)
    np.testing.assert_allclose(float(metrics['total_loss']),
                               float(want['total']), rtol=tol)


def _check_stats(trainer, variables, want, tol):
    """The new BN statistics, and that they moved."""
    stats = state_to_flax(trainer.module)['batch_stats']
    want_stats = flatten(want['stats'])
    old_stats = flatten(variables['batch_stats'])
    assert set(stats) == set(want_stats)
    for k, w in want_stats.items():
        assert_close(stats[k], w, tol, f'batch_stats {k}')
        assert np.abs(w - old_stats[k]).max() > 0, k


def _check_params(trainer, before, want, cfg, sure_tol):
    """The parameters after one step.  Adam's first update is
    lr * g / (|g| + eps) ~ lr * sign(g): where |g| is at rounding level its
    sign is noise, and a parameter may differ by up to 2 * lr.  So every
    element within 2 * lr, every element whose gradient is well above the
    noise (|g| >= 10 * sure_tol of the leaf's scale: both signs agree) within
    1e-3 * lr, and every leaf moved."""
    lr = cfg.OPTIMIZER.LR
    params = state_to_flax(trainer.module)['params']
    raw = flatten(want['grads'])
    floor = float(np.median([np.abs(g).max() for g in raw.values()]))
    n_sure = 0
    for k, w in flatten(want['params']).items():
        diff = np.abs(params[k] - w)
        assert diff.max() <= 2.001 * lr, k
        scale = max(float(np.abs(raw[k]).max()), floor)
        sure = np.abs(raw[k]) >= 10 * sure_tol * scale
        n_sure += int(sure.sum())
        assert (diff[sure] <= 1e-3 * lr + 1e-6 * np.abs(w[sure])).all(), k
        assert np.abs(params[k] - before[k]).max() > 0.5 * lr, k
    return n_sure


def test_train_step_matches_jax_in_float64(jax_step_x64):
    cfg, batch, variables, want = jax_step_x64
    trainer, metrics, before = _port_step(cfg, batch, variables, 'scatter',
                                          double=True)
    assert metrics['total_loss'].dtype == torch.float64
    _check_losses(metrics, want, 1e-6)
    np.testing.assert_allclose(float(metrics['grad_norm']),
                               float(want['norm']), rtol=1e-4)
    assert float(want['norm']) > cfg.GRAD_NORM_CLIP     # the clip is active
    # every gradient leaf (the port's are clipped in place, so against the
    # JAX gradients through optax's clip), 1e-3 of the larger of the leaf's
    # scale and the tree's median leaf scale (a leaf that is zero by
    # construction holds only noise)
    grads = state_to_flax(trainer.module, grads=True)['params']
    want_grads = flatten(want['clipped'])
    assert set(grads) == set(want_grads)
    floor = float(np.median([np.abs(w).max() for w in want_grads.values()]))
    for k, w in want_grads.items():
        _leaf_close(grads[k], w, 1e-3, floor, f'grad {k}')
    _check_stats(trainer, variables, want, 1e-6)
    n_sure = _check_params(trainer, before, want, cfg, 1e-3)
    assert n_sure > 0.5 * sum(g.size for g in grads.values())


@pytest.mark.parametrize('backend,tol', [('scatter', 1e-3),
                                         ('pallas_patch', 2e-3)])
def test_train_step_matches_jax(jax_step, backend, tol):
    """fp32, as users run it.  'scatter' is the JAX run's own pool.
    'pallas_patch' (its plain version here; the JAX kernel cannot run inside
    a model on the CPU) is held against JAX 'scatter': with no row dropped
    they differ by the bf16 rounding of the lifted camera features."""
    cfg, batch, variables, want = jax_step
    trainer, metrics, before = _port_step(cfg, batch, variables, backend)
    if backend == 'pallas_patch':
        assert int(PP.last_drops.sum()) == 0
    _check_losses(metrics, want, tol)
    np.testing.assert_allclose(float(metrics['grad_norm']),
                               float(want['norm']), rtol=0.1)
    _check_stats(trainer, variables, want, 5 * tol)
    # gradient leaves behind the ill-conditioned stack: the decoder's heads
    # and the task weights, unclipped (the two norms differ by a few %)
    unclip = max(float(metrics['grad_norm']) / cfg.GRAD_NORM_CLIP, 1.0)
    grads = state_to_flax(trainer.module, grads=True)['params']
    raw = flatten(want['grads'])
    assert set(grads) == set(raw)
    heads = [k for k in raw if '_head_' in k or k.startswith('task_weights')]
    assert len(heads) > 20
    floor = float(np.median([np.abs(raw[k]).max() for k in heads]))
    for k in heads:
        _leaf_close(grads[k] * unclip, raw[k], 50 * tol, floor, f'grad {k}')
    # the whole tree points the same way
    dot = sum(float((grads[k] * raw[k]).sum()) for k in raw)
    norms = [np.sqrt(sum(float((t[k] ** 2).sum()) for k in raw))
             for t in (grads, raw)]
    assert dot / (norms[0] * norms[1]) > 0.8
    _check_params(trainer, before, want, cfg, 1.0)


def test_fp32_rounding_moves_the_tiny_steps_gradient():
    """Why the fp32 bars above are loose: the port against itself, the same
    weights (seed 0) and batch with fp32 and with fp64 parameters.  Both
    compute one function, so they differ by fp32 rounding as the step
    amplifies it: the losses agree to 1e-5, the gradient leaves do not agree
    to 5e-3 of their scale (the bar of the fusion forward) and stay within
    0.5 of it (0.07 measured; the order of a machine's sums moves it)."""
    cfg = PConfig().merge_dict(_cfg().to_dict())
    batch = make_batch(cfg, 1, seed=5, n_points=2048)
    losses, grads = {}, {}
    for dtype in (torch.float32, torch.float64):
        cfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = str(dtype).split('.')[-1]
        trainer = P.build_trainer(cfg, device='cpu', seed=0)
        trainer.module.to(dtype)
        for m in trainer.module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        metrics = P.train_step(trainer, batch)
        losses[dtype] = metrics
        # as backward left them: train_step clips in place
        unclip = max(float(metrics['grad_norm']) / cfg.GRAD_NORM_CLIP, 1.0)
        grads[dtype] = {
            k: g * unclip for k, g in
            state_to_flax(trainer.module, grads=True)['params'].items()}
    for k, w in losses[torch.float64].items():
        if k != 'grad_norm':
            np.testing.assert_allclose(float(losses[torch.float32][k]),
                                       float(w), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    g64 = grads[torch.float64]
    floor = float(np.median([np.abs(g).max() for g in g64.values()]))
    rel = sorted(float(np.abs(grads[torch.float32][k] - g).max())
                 / max(float(np.abs(g).max()), floor) for k, g in g64.items())
    print('fp32 vs fp64 gradient leaves: worst', rel[-1], 'median',
          rel[len(rel) // 2])
    assert 5e-3 < rel[-1] < 0.5, rel[-1]


def test_train_step_with_a_bf16_lidar_branch():
    """SPARSE_ENCODER.COMPUTE_DTYPE = 'bfloat16' (the flagship's setting)
    under fp32 parameters: the LiDAR branch's output is rounded to bf16 and
    widened where it meets the fp32 weights, as flax promotes, so the step
    runs and lands near the all-fp32 step."""
    cfg = PConfig().merge_dict(_cfg().to_dict())
    batch = make_batch(cfg, 1, seed=5, n_points=2048)
    losses = {}
    for dtype in ('auto', 'bfloat16'):
        cfg.MODEL.SPARSE_ENCODER.COMPUTE_DTYPE = dtype
        trainer = P.build_trainer(cfg, device='cpu', seed=0)
        metrics = P.train_step(trainer, batch,
                               generator=torch.Generator().manual_seed(0))
        assert all(torch.isfinite(v) for v in metrics.values())
        assert metrics['total_loss'].dtype == torch.float32
        losses[dtype] = float(metrics['total_loss'])
    assert losses['auto'] != losses['bfloat16']
    np.testing.assert_allclose(losses['bfloat16'], losses['auto'], rtol=2e-2)


def test_optimizer_chain_matches_optax():
    """The same numpy gradients into optax's chain and into the port's
    (clip_grad_norm_, then Adam with weight decay) for 3 steps: 1e-6.  The
    first step's norm is above GRAD_NORM_CLIP, the others below; a large
    weight decay makes its place in the chain visible."""
    cfg = _cfg()
    cfg.OPTIMIZER.WEIGHT_DECAY = 1e-2
    pcfg = PConfig().merge_dict(cfg.to_dict())
    rng = np.random.RandomState(0)
    shapes = {'a': (4, 3), 'b': (5,), 'c': ()}
    params = {k: np.asarray(rng.randn(*s), np.float32)
              for k, s in shapes.items()}
    steps = [{k: np.asarray(g * rng.randn(*s), np.float32)
              for k, s in shapes.items()} for g in (10.0, 0.1, 1e-4)]

    tx = _chain(cfg)
    jparams = jnp_tree(params)
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(np.array(v)))
               for v in params.values()]
    opt = PT.make_optimizer(tparams, pcfg)
    for i, g in enumerate(steps):
        upd, opt_state = tx.update(jnp_tree(g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, v in zip(tparams, g.values()):
            p.grad = torch.from_numpy(np.array(v))
        norm = torch.nn.utils.clip_grad_norm_(tparams, pcfg.GRAD_NORM_CLIP)
        assert (float(norm) > pcfg.GRAD_NORM_CLIP) == (i == 0)
        opt.step()
        for p, (k, w) in zip(tparams, jparams.items()):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6, err_msg=f'{k}')


def test_eval_forward_matches_the_eval_model(jax_step):
    """eval_forward: running statistics, no dropout, no parameter moves."""
    cfg, batch, variables, _ = jax_step
    pcfg = PConfig().merge_dict(cfg.to_dict())
    trainer = P.build_trainer(pcfg, device='cpu')
    load_flax_variables(trainer.module, variables)
    out = P.eval_forward(trainer, batch)
    assert not trainer.module.training
    model = P.build_model(pcfg, device='cpu')
    model.load_state_dict(trainer.module.model.state_dict())
    with torch.no_grad():
        want = model(**P.batch_to_model_args(batch, pcfg, device='cpu'))
    for k, w in want.items():
        assert (w is None and out[k] is None) or torch.equal(out[k], w), k
