"""The port's training losses, ``compute_losses`` and
``prepare_future_labels`` vs the JAX package's, on the same numpy inputs.

Bar: 1e-5 relative for each loss value and for its gradient w.r.t. the
prediction (``jax.grad``); warped labels equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.training import losses as JL
from streamingflow_tpu.training import trainer as JT
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.training import losses as PL
from streamingflow_tpu_torch.training import trainer as PT

from torch_parity import assert_close, jnp_tree, t

TOL = 1e-5
RNG = np.random.RandomState(0)


def _value_and_grad(jfn, pfn, pred, *rest, **kw):
    """Both losses and both gradients w.r.t. ``pred``; ``rest`` are the
    other array arguments."""
    want, want_g = jax.value_and_grad(
        lambda p: jfn(p, *(jnp.asarray(a) for a in rest), **kw))(
        jnp.asarray(pred))
    p = t(pred).requires_grad_()
    got = pfn(p, *(t(a) for a in rest), **kw)
    got.backward()
    return got, p.grad, np.asarray(want), np.asarray(want_g)


def _check(got, got_g, want, want_g, what):
    """Value and gradient within 1e-5 of the value / the gradient's scale."""
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL,
                               atol=1e-7, err_msg=what)
    err = float(np.abs(got_g.numpy() - want_g).max())
    scale = float(np.abs(want_g).max())
    assert err <= TOL * scale + 1e-12, (
        f'{what} grad: max abs err {err:.3g} over scale {scale:.3g}')


def _seg_inputs(ignore=True):
    pred = RNG.randn(2, 4, 6, 5, 2).astype(np.float32)
    tgt = (RNG.rand(2, 4, 6, 5, 1) > 0.7).astype(np.int32)
    if ignore:
        tgt[RNG.rand(*tgt.shape) > 0.9] = 255
    return pred, tgt


@pytest.mark.parametrize('use_top_k,ratio', [(False, 1.0), (True, 0.25)])
@pytest.mark.parametrize('discount', [1.0, 0.9])
def test_segmentation_loss(use_top_k, ratio, discount):
    pred, tgt = _seg_inputs()
    kw = dict(class_weights=[1.0, 2.0], n_present=2, use_top_k=use_top_k,
              top_k_ratio=ratio, future_discount=discount)
    _check(*_value_and_grad(JL.segmentation_loss, PL.segmentation_loss,
                            pred, tgt, **kw), 'segmentation_loss')


def test_discounts():
    want = np.asarray(JL._discounts(5, 2, 0.9))
    np.testing.assert_allclose(PL._discounts(5, 2, 0.9).numpy(), want,
                               rtol=1e-6)


@pytest.mark.parametrize('norm', [1, 2])
@pytest.mark.parametrize('discount', [1.0, 0.9])
def test_spatial_regression_loss(norm, discount):
    pred = RNG.randn(2, 4, 6, 5, 2).astype(np.float32)
    tgt = RNG.randn(2, 4, 6, 5, 2).astype(np.float32)
    tgt[RNG.rand(2, 4, 6, 5) > 0.8] = 255.0
    kw = dict(norm=norm, n_present=2, future_discount=discount)
    _check(*_value_and_grad(JL.spatial_regression_loss,
                            PL.spatial_regression_loss, pred, tgt, **kw),
           f'spatial_regression_loss L{norm}')


def test_spatial_regression_loss_all_masked_is_zero():
    pred = RNG.randn(1, 3, 4, 4, 2).astype(np.float32)
    tgt = np.full((1, 3, 4, 4, 2), 255.0, np.float32)
    got, got_g, want, want_g = _value_and_grad(
        JL.spatial_regression_loss, PL.spatial_regression_loss, pred, tgt,
        norm=1, n_present=2)
    assert float(got.detach()) == float(want) == 0.0
    assert not got_g.numpy().any() and not want_g.any()
    with pytest.raises(ValueError, match='norm'):
        PL.spatial_regression_loss(t(pred), t(tgt), norm=3)


def test_hdmap_loss():
    pred = RNG.randn(2, 6, 5, 4).astype(np.float32)
    tgt = (RNG.rand(2, 2, 6, 5) > 0.5).astype(np.int32)
    tgt[RNG.rand(*tgt.shape) > 0.9] = 255
    kw = dict(class_weights=[[1.0, 2.0], [1.0, 3.0]],
              training_weights=[1.0, 0.5], use_top_k=[True, False],
              top_k_ratio=[0.5, 1.0])
    _check(*_value_and_grad(JL.hdmap_loss, PL.hdmap_loss, pred, tgt, **kw),
           'hdmap_loss')


def test_depth_loss():
    pred = RNG.randn(1, 2, 2, 4, 5, 8).astype(np.float32)
    tgt = RNG.randint(0, 8, (1, 2, 2, 4, 5)).astype(np.int32)
    tgt[RNG.rand(*tgt.shape) > 0.9] = 255
    _check(*_value_and_grad(JL.depth_loss, PL.depth_loss, pred, tgt),
           'depth_loss')


def test_probabilistic_loss():
    mu, ls, fmu, fls = (0.5 * RNG.randn(2, 1, 8).astype(np.float32)
                        for _ in range(4))
    _check(*_value_and_grad(JL.probabilistic_loss, PL.probabilistic_loss,
                            mu, ls, fmu, fls), 'probabilistic_loss')


def _cfgs():
    cfg = tiny_config()
    cfg.SEMANTIC_SEG.PEDESTRIAN.ENABLED = True
    cfg.SEMANTIC_SEG.HDMAP.ENABLED = True
    cfg.SEMANTIC_SEG.VEHICLE.USE_TOP_K = True
    cfg.SEMANTIC_SEG.VEHICLE.TOP_K_RATIO = 0.25
    return cfg, PConfig().merge_dict(cfg.to_dict())


LABEL_KEYS = ('segmentation', 'pedestrian', 'instance', 'centerness',
              'offset', 'flow', 'hdmap', 'depths')


def test_prepare_future_labels():
    """Every label of one make_batch: integer labels equal, float labels at
    1e-5, depth bins equal."""
    cfg, pcfg = _cfgs()
    batch = make_batch(cfg, 2, seed=7, n_points=16)
    with jax.default_matmul_precision('highest'):
        want = JT.prepare_future_labels(jnp_tree(batch), cfg)
    got = PT.prepare_future_labels({k: t(v) for k, v in batch.items()}, pcfg)
    assert set(got) == set(want)
    for k in LABEL_KEYS:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        if np.issubdtype(w.dtype, np.integer):
            assert got[k].dtype == torch.int32, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            assert_close(got[k], w, TOL, k)
    assert np.asarray(want['segmentation']).any()


def test_compute_losses_every_key():
    """One fixed output dict through both ``compute_losses``: every entry,
    with non-zero task weights."""
    cfg, pcfg = _cfgs()
    b, s, n = 1, 4, 2
    h = w = 32
    out = {
        'segmentation': RNG.randn(b, s, h, w, 2),
        'pedestrian': RNG.randn(b, s, h, w, 2),
        'hdmap': RNG.randn(b, h, w, 4),
        'instance_center': RNG.rand(b, s, h, w, 1),
        'instance_offset': RNG.randn(b, s, h, w, 2),
        'instance_flow': RNG.randn(b, s, h, w, 2),
        'depth_prediction': RNG.randn(b, 2, n, 4, 8, 8),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    batch = make_batch(cfg, 1, seed=8, n_points=16)
    with jax.default_matmul_precision('highest'):
        labels = JT.prepare_future_labels(jnp_tree(batch), cfg)
    names = PT.task_names(pcfg)
    weights = {k: np.float32(0.3 * RNG.randn()) for k in names}
    want = JT.compute_losses(jnp_tree(out), labels,
                             {k: jnp.asarray(v) for k, v in weights.items()},
                             cfg)
    got = PT.compute_losses(
        {k: t(v) for k, v in out.items()},
        {k: t(np.asarray(v)) for k, v in labels.items() if v is not None},
        {k: t(np.asarray(v)) for k, v in weights.items()}, pcfg)
    assert set(got) == set(want) and len(want) == 2 * len(names)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=TOL,
                                   atol=1e-7, err_msg=k)


def test_task_weights_are_zero_scalars_under_the_flax_names():
    _, pcfg = _cfgs()
    tw = PT.TaskWeights(pcfg)
    names = [n for n, _ in tw.named_parameters()]
    assert names == [f'{n}_weight' for n in PT.task_names(pcfg)]
    assert all(p.shape == () and float(p) == 0.0 for p in tw.parameters())
