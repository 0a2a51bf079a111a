"""Train mode of the port's modules vs the JAX package's: the forward with
batch statistics, the updated running statistics, and the gradients w.r.t.
the input and every parameter (``jax.grad`` of the output contracted with a
fixed random cotangent), leaf by leaf through the bridge's way back.

Bar: 1e-5 of each leaf's scale (the pillar encoder 1e-4, as in eval mode;
the EfficientNet encoder 1e-4 and 5e-3 for its gradients: see the tests).
flax's dropout and drop-connect streams cannot be reproduced in torch, so
both sides run with them neutralised (from here: no file of the JAX package
changes); the port's own masks are tested below on their own.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.layers import conv as jconv
from streamingflow_tpu.layers import temporal as jtemporal
from streamingflow_tpu.models import decoder as jdec
from streamingflow_tpu.models import efficientnet as jeff
from streamingflow_tpu.models import encoder as jenc
from streamingflow_tpu.models import pillar_encoder as jpe
from streamingflow_tpu_torch.convert import (flatten, load_flax_variables,
                                             state_to_flax)
from streamingflow_tpu_torch.layers import conv as pconv
from streamingflow_tpu_torch.layers import srvp as psrvp
from streamingflow_tpu_torch.layers import temporal as ptemporal
from streamingflow_tpu_torch.layers.trainmode import (BatchNorm, Dropout,
                                                      remat, set_generator)
from streamingflow_tpu_torch.models import decoder as pdec
from streamingflow_tpu_torch.models import efficientnet as peff
from streamingflow_tpu_torch.models import encoder as penc
from streamingflow_tpu_torch.models import pillar_encoder as ppe

from torch_parity import assert_close, init_jax, nchw, nhwc, seq, t

TOL = 1e-5


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, '__call__',
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    monkeypatch.setattr(jeff, '_DROP_CONNECT_RATE', 0.0)


def _no_dropout(module):
    for m in module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return module


def _leaves(out):
    """A module's outputs as a flat {name: array} dict, None dropped."""
    if isinstance(out, dict):
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(out, (tuple, list)):
        return {str(i): v for i, v in enumerate(out)}
    return {'out': out}


def _jax_train(jm, variables, x, cots, diff_input=True, jit=True):
    """Outputs, new batch_stats, gradient of sum(out * cot) w.r.t. the
    params and the input, with the JAX module in train mode."""
    def loss(params, xin):
        out, upd = jm.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            xin, train=True, mutable=['batch_stats'],
            rngs={'dropout': jax.random.PRNGKey(0)})
        total = sum(jnp.vdot(v, cots[k]) for k, v in _leaves(out).items())
        return total, (_leaves(out), upd['batch_stats'])

    with jax.default_matmul_precision('highest'):
        fn = jax.value_and_grad(
            loss, argnums=(0, 1) if diff_input else (0,), has_aux=True)
        (_, (out, stats)), grads = (jax.jit(fn) if jit else fn)(
            variables['params'], jnp.asarray(x))
    return jax.tree.map(np.asarray, (out, stats, grads))


def _check_train(jm, pm, x, to_torch, from_torch, tol=TOL, grad_tol=None,
                 diff_input=True, seed=0, jit=True):
    """Train-mode parity of ``pm`` with ``jm`` on input ``x`` (numpy, JAX
    layout).  ``to_torch`` lays the input out for the port, ``from_torch``
    brings an output or the input gradient back to the JAX layout.

    A gradient leaf is held to ``grad_tol`` (``tol`` unless given) of the
    larger of its own scale and the median leaf scale of the tree: a leaf
    that is zero by construction (a BN bias in front of another
    batch-statistics BN) holds only the rounding noise of the sums it
    cancels, which grows with the tree's scale, not with its own."""
    grad_tol = tol if grad_tol is None else grad_tol
    variables = init_jax(jm, jnp.asarray(x))
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda v, a: jm.apply(v, a), variables,
                            jnp.asarray(x))
    cots = {k: rng.randn(*s.shape).astype(np.float32)
            for k, s in _leaves(shapes).items()}
    want, want_stats, want_grads = _jax_train(jm, variables, x, cots,
                                              diff_input, jit)

    pm = _no_dropout(load_flax_variables(pm, variables)).train()
    xin = to_torch(x).requires_grad_(diff_input)
    got = _leaves(pm(xin))
    assert set(got) == set(want)
    total = sum((from_torch(v) * t(cots[k])).sum() for k, v in got.items())
    total.backward()
    for k, w in want.items():
        assert_close(from_torch(got[k]), w, tol, f'train forward {k}')
    stats = state_to_flax(pm)['batch_stats']
    want_stats = flatten(want_stats)
    old_stats = flatten(variables['batch_stats'])
    assert set(stats) == set(want_stats) and stats
    for k, w in want_stats.items():
        assert_close(stats[k], w, tol, f'batch_stats {k}')
        assert np.abs(w - old_stats[k]).max() > 0, k
    grads = state_to_flax(pm, grads=True)['params']
    want_params = flatten(want_grads[0])
    assert set(grads) == set(want_params)
    tree_scale = float(np.median([np.abs(w).max()
                                  for w in want_params.values()]))
    assert tree_scale > 1e-3

    def grad_close(got_leaf, w, what):
        err = float(np.abs(np.asarray(got_leaf) - w).max())
        scale = max(float(np.abs(w).max()), tree_scale)
        assert got_leaf.shape == w.shape and err <= grad_tol * scale, (
            f'{what}: max abs err {err:.3g} over scale {scale:.3g} exceeds '
            f'{grad_tol:g}')

    for k, w in want_params.items():
        grad_close(grads[k], w, f'grad {k}')
    if diff_input:
        grad_close(from_torch(xin.grad).numpy(), want_grads[1], 'grad input')
    return pm


def test_conv_block(no_flax_dropout):
    x = np.random.RandomState(1).randn(2, 8, 9, 5).astype(np.float32)
    _check_train(jconv.ConvBlock(7), pconv.ConvBlock(5, 7), x, nchw,
                 lambda y: y.movedim(-3, -1))


@pytest.mark.parametrize('batch', [1, 2])
def test_aspp(no_flax_dropout, batch):
    """At batch 1 the image-pool branch normalises one value per channel:
    variance 0, output = the bias, as in flax."""
    x = np.random.RandomState(2).randn(batch, 10, 12, 6).astype(np.float32)
    _check_train(jconv.ASPP(8, atrous_rates=(2, 3, 4)),
                 pconv.ASPP(6, 8, atrous_rates=(2, 3, 4)), x, nchw,
                 lambda y: y.movedim(-3, -1))


def test_deeplab_head_batch_1(no_flax_dropout):
    x = np.random.RandomState(3).randn(1, 8, 8, 6).astype(np.float32)
    _check_train(jconv.DeepLabHead(5, hidden_channel=8),
                 pconv.DeepLabHead(6, 5, hidden_channel=8), x, nchw,
                 lambda y: y.movedim(-3, -1))


def test_temporal_block(no_flax_dropout):
    x = np.random.RandomState(4).randn(1, 3, 8, 8, 12).astype(np.float32)
    kw = dict(use_pyramid_pooling=True, pool_sizes=[(2, 8, 8)])
    _check_train(jtemporal.TemporalBlock(16, **kw),
                 ptemporal.TemporalBlock(12, 16, **kw), x,
                 lambda a: t(a).permute(0, 4, 1, 2, 3).contiguous(),
                 lambda y: y.permute(0, 2, 3, 4, 1))


def test_pillar_encoder(no_flax_dropout):
    cfg = tiny_config()
    se = cfg.MODEL.SPARSE_ENCODER
    pts = make_batch(cfg, 1, seed=2, n_points=1024)['points'][:, :2]
    # 1e-4: the eval-mode bar of this module (tests/test_torch_modules.py).
    # The JAX side runs op by op: under jit XLA contracts the z-std
    # epilogue of pillarize differently, a few hundred bf16 pillar features
    # land one bf16 step away from the op-by-op result (which the port
    # equals bit for bit), and batch-statistics BN over the mostly empty
    # grid amplifies those steps to 2e-4 of the output's scale.
    _check_train(jpe.PillarBEVEncoder(se, tile_sorted=True),
                 ppe.PillarBEVEncoder(se, tile_sorted=True), pts, t,
                 lambda y: y.movedim(-3, -1), tol=1e-4, diff_input=False,
                 jit=False)


def test_encoder_b0(no_flax_dropout):
    x = np.random.RandomState(5).randn(2, 32, 64, 3).astype(np.float32)
    # ~50 batch-statistics BNs in sequence, the last ones over 64 values a
    # channel, amplify fp32 rounding.  Forward 1e-4: the port in fp32 and
    # the JAX module each sit 4e-5 to 9e-5 of the output's scale from the
    # port run in fp64.  Gradients 5e-3 (the composed-stack bar): the port's
    # fp32 gradients sit 4e-4 of a leaf's scale from its fp64 gradients, and
    # the JAX module's 3e-3 from the port's.
    _check_train(jenc.Encoder(out_channels=16, depth_channels=8,
                              backbone_name='efficientnet-b0'),
                 penc.Encoder(16, 8, 'efficientnet-b0'), x, nchw,
                 lambda y: y.movedim(-3, -1), tol=1e-4, grad_tol=5e-3)


def test_decoder(no_flax_dropout):
    x = np.random.RandomState(6).randn(1, 3, 32, 32, 16).astype(np.float32)
    kw = dict(n_classes=2, n_present=2, n_hdmap=2, predict_pedestrian=True,
              perceive_hdmap=True, predict_instance=True,
              predict_future_flow=True, planning=False)
    _check_train(jdec.Decoder(**kw), pdec.Decoder(16, **kw), x, seq,
                 lambda y: y.movedim(-3, -1))


# ------------------------------------------------ the port's own train rules
def test_batch_norm_running_variance_is_the_biased_one():
    """flax moves the running variance toward the biased batch variance;
    torch.nn.BatchNorm2d would take the unbiased one (n / (n - 1) larger)."""
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    bn = BatchNorm(3, momentum=0.1).train()
    ref = torch.nn.BatchNorm2d(3, momentum=0.1).train()
    y, y_ref = bn(x), ref(x)
    assert_close(y, y_ref.detach().numpy(), 1e-6, 'normalised output')
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    assert_close(bn.running_var, (0.9 + 0.1 * biased).numpy(), 1e-6)
    n = x.numel() // 3
    assert_close(ref.running_var, (0.9 + 0.1 * biased * n / (n - 1)).numpy(),
                 1e-6)
    assert_close(bn.running_mean, ref.running_mean.numpy(), 1e-6)


def test_batch_norm_over_one_value_per_channel():
    """Variance 0: the output is the bias, no gradient reaches the input or
    the scale, and the running variance moves toward 0; F.batch_norm in
    training refuses this input."""
    x = torch.randn(1, 4, 1, 1).requires_grad_()
    bn = BatchNorm(4, momentum=0.1).train()
    torch.nn.init.normal_(bn.bias)
    y = bn(x)
    y.sum().backward()
    assert torch.equal(y.detach().flatten(), bn.bias.detach())
    assert not x.grad.any() and not bn.weight.grad.any()
    assert torch.equal(bn.bias.grad, torch.ones(4))
    assert_close(bn.running_var, np.full(4, 0.9, np.float32), 1e-6)
    assert_close(bn.running_mean, 0.1 * x.detach().flatten().numpy(), 1e-6)
    with pytest.raises(ValueError, match='more than 1 value'):
        torch.nn.BatchNorm2d(4).train()(x)


def test_eval_mode_uses_running_statistics_and_leaves_them():
    bn = BatchNorm(3).eval()
    bn.running_mean.fill_(0.5)
    x = torch.randn(2, 3, 4, 4)
    want = (x - 0.5) / (1 + bn.eps) ** 0.5
    assert_close(bn(x), want.numpy(), 1e-6)
    assert float(bn.running_mean[0]) == 0.5


@pytest.mark.parametrize('rate', [0.25, 0.5])
def test_dropout_rate_scale_and_generator(rate):
    x = torch.ones(64, 32, 8, 8)
    drop = Dropout(rate).train()
    drop.generator = torch.Generator().manual_seed(1)
    a = drop(x)
    kept = a != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / (1 - rate)))
    drop.generator = torch.Generator().manual_seed(1)
    assert torch.equal(drop(x), a)                 # same seed, same mask
    drop.generator = torch.Generator().manual_seed(2)
    assert not torch.equal(drop(x), a)
    assert torch.equal(drop.eval()(x), x)


def test_drop_connect_is_per_sample():
    """One draw per batch element: a sample's residual branch is kept whole
    (scaled by 1 / keep) or dropped whole, at rate _DROP_CONNECT_RATE * idx /
    n_blocks; nothing raises in train mode."""
    backbone = peff.EfficientNetBackbone('efficientnet-b0')
    rates = [getattr(backbone, f'block_{i}').drop_connect.rate
             for i in range(backbone.n_blocks)]
    assert rates == [peff._DROP_CONNECT_RATE * i / backbone.n_blocks
                     for i in range(backbone.n_blocks)]
    drop = Dropout(0.5, per_sample=True).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(256, 3, 4, 4))
    per_sample = y.flatten(1)
    assert ((per_sample == 0).all(1) | (per_sample == 2).all(1)).all()
    assert 0.35 < float((per_sample[:, 0] == 0).float().mean()) < 0.65
    backbone.train()
    set_generator(backbone, torch.Generator().manual_seed(0))
    out = backbone(torch.randn(4, 3, 32, 64))
    assert all(torch.isfinite(o).all() for o in out)


def _remat_run(use_remat, seed=3):
    """A ResBlock (BatchNorm + dropout 0.25) and an ASPP (dropout 0.5) in
    train mode, masks from an explicit generator; returns the output, the
    gradients, the BN buffers and the generator's final state."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(psrvp.ResBlock(6, 8),
                              pconv.ASPP(8, 8, atrous_rates=(1, 2, 3))).train()
    gen = torch.Generator().manual_seed(seed)
    set_generator(net, gen)
    x = torch.randn(2, 6, 8, 8, generator=torch.Generator().manual_seed(9),
                    requires_grad=True)
    out = remat(net, net, gen, x) if use_remat else net(x)
    out.square().sum().backward()
    grads = [x.grad] + [p.grad for p in net.parameters()]
    return out.detach(), grads, list(net.buffers()), gen.get_state()


def test_remat_equals_no_remat_with_dropout_on():
    """Rematerialised: the recompute redraws the first run's masks (not new
    ones from the advanced generator) and does not move the BN statistics a
    second time, so output, gradients and buffers are those of the plain
    run, and the generator ends where the plain run leaves it."""
    out_a, grads_a, bufs_a, state_a = _remat_run(False)
    out_b, grads_b, bufs_b, state_b = _remat_run(True)
    assert (out_a == 0).any()                       # dropout is on
    assert torch.equal(out_a, out_b)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)
    for a, b in zip(bufs_a, bufs_b):
        assert torch.equal(a, b)
    assert torch.equal(state_a, state_b)
    other = _remat_run(True, seed=4)[0]
    assert not torch.equal(other, out_b)
