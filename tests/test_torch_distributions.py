"""The distribution head of the PyTorch port against the JAX package:
``Bottleneck`` (plain, stride 2, transposed x2; identity and projected
skips), ``DistributionModule`` for each method, ``distribution_forward``,
and the head's place in the model and the bridge.

Bars: 1e-5 of the output's scale for the modules, eval mode (the JAX
package's single-module bar); 1e-6 for ``distribution_forward`` without
noise (a handful of elementwise ops on the same inputs).  The noise of the
two packages comes from different generators, so with noise the port is
held to its own formula on its own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import tiny_config
from streamingflow_tpu.layers import conv as jconv
from streamingflow_tpu.models import StreamingFlow as JStreamingFlow
from streamingflow_tpu.models import distributions as jdist
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import flax_to_state_dict
from streamingflow_tpu_torch.layers import conv as pconv
from streamingflow_tpu_torch.models import distributions as pdist
from streamingflow_tpu_torch.models.streamingflow import StreamingFlow

from torch_parity import (apply_jax, assert_close, init_jax, nchw, nhwc,
                          port, port_like, t)

TOL = 1e-5
B, H, W, C, L = 2, 16, 16, 8, 4


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('kind,cout', [('plain', None), ('plain', 12),
                                       ('downsample', None),
                                       ('upsample', None), ('upsample', 6)])
def test_bottleneck(kind, cout):
    x = _x(2, 8, 10, C)
    flags = dict(downsample=kind == 'downsample',
                 upsample=kind == 'upsample')
    jm = jconv.Bottleneck(cout, **flags)
    v = init_jax(jm, jnp.asarray(x))
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(pconv.Bottleneck(C, cout, **flags), v)
    with torch.no_grad():
        got = pm(nchw(x))
    size = {'plain': (8, 10), 'downsample': (4, 5), 'upsample': (16, 20)}
    assert tuple(got.shape[2:]) == size[kind]
    assert_close(nhwc(got), want, TOL, f'Bottleneck {kind} {cout}')


def _head(method, seed=0):
    x = _x(B, 1, H, W, C, seed=seed)
    jm = jdist.DistributionModule(in_channels=C, latent_dim=L, method=method)
    v = init_jax(jm, jnp.asarray(x))
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(pdist.DistributionModule(C, L, method), v)
    with torch.no_grad():
        got = pm(t(x))
    return got, want


@pytest.mark.parametrize('method,shape', [
    ('GAUSSIAN', (B, 1, 2 * L)), ('MIXGAUSSIAN', (B, 1, 6 * L + 3)),
    ('BERNOULLI', (B, 1, H, W, L))])
def test_distribution_module(method, shape):
    got, want = _head(method)
    assert tuple(got.shape) == shape
    assert_close(got, want, TOL, method)
    # without noise the samples agree, from the same parameters
    p = np.asarray(want)
    jsample = np.asarray(jdist.distribution_forward(
        jnp.asarray(p), L, method, (H, W), None))
    psample = pdist.distribution_forward(t(p), L, method, (H, W), None)
    assert tuple(psample.shape) == (B, 1, H, W, L)
    assert_close(psample, jsample, 1e-6, f'{method} sample')


def test_gaussian_noise_and_log_sigma_clip():
    """mu + exp(clip(log sigma)) noise, the noise drawn from the generator
    (shaped like mu); the clip bounds a huge log sigma at e^5."""
    p = torch.cat([torch.zeros(1, 1, L), torch.full((1, 1, L), 100.0)], -1)
    gen = torch.Generator().manual_seed(3)
    s = pdist.distribution_forward(p, L, 'GAUSSIAN', (2, 2), gen)
    noise = torch.randn((1, 1, L), generator=torch.Generator().manual_seed(3))
    want = np.exp(5.0) * noise[:, :, None, None, :].expand(1, 1, 2, 2, L)
    assert_close(s, want.numpy(), 1e-6, 'clipped sample')
    assert torch.isfinite(s).all()
    # the other bound: a tiny log sigma is held at e^-5
    p = torch.cat([torch.ones(1, 1, L), torch.full((1, 1, L), -100.0)], -1)
    s = pdist.distribution_forward(
        p, L, 'GAUSSIAN', (2, 2), torch.Generator().manual_seed(3))
    assert_close(s[0, 0, 0, 0], (1.0 + np.exp(-5.0) * noise[0, 0]).numpy(),
                 1e-6, 'low clip')


@pytest.mark.parametrize('method', ['MIXGAUSSIAN', 'BERNOULLI'])
def test_noise_moves_the_sample(method):
    got, _ = _head(method)
    mean = pdist.distribution_forward(got, L, method, (H, W), None)
    s = pdist.distribution_forward(got, L, method, (H, W),
                                   torch.Generator().manual_seed(0))
    assert s.shape == mean.shape and torch.isfinite(s).all()
    assert not torch.allclose(s, mean)


def _model_cfg(method='GAUSSIAN'):
    cfg = tiny_config()
    cfg.PROBABILISTIC.ENABLED = True
    cfg.PROBABILISTIC.METHOD = method
    cfg.MODEL.BEV_POOL_BACKEND = 'scatter'
    return cfg


@pytest.fixture(scope='module')
def jax_tree():
    """A tiny PROBABILISTIC model's JAX variables: init never calls the
    head, so the tree has none of its leaves."""
    cfg = _model_cfg()
    v = init_jax(JStreamingFlow(cfg), like=port_like(cfg))
    assert 'present_distribution' not in v['params']
    return cfg, v


def test_model_without_head_leaves_converts_strictly(jax_tree):
    cfg, v = jax_tree
    pcfg = PConfig().merge_dict(cfg.to_dict())
    model = StreamingFlow(pcfg)
    before = {k: x.clone() for k, x in model.state_dict().items()
              if k.startswith('present_distribution.')}
    assert before
    state = flax_to_state_dict(model, v)
    # the head keeps the module's own values; everything else is the tree's
    for k, x in before.items():
        assert torch.equal(state[k], x), k
    model.load_state_dict(state, strict=True)
    # strict elsewhere: a leaf missing outside the head still raises
    params = dict(v['params'])
    params['decoder'] = {k: w for k, w in params['decoder'].items()
                         if k != 'first_conv'}
    with pytest.raises(KeyError, match='first_conv'):
        flax_to_state_dict(model, {**v, 'params': params})


def test_model_head_from_the_tree(jax_tree):
    """A tree that holds the head fills it, and is held to all its leaves;
    the model's distribution_forward then equals the JAX module's (eval:
    no noise), and a train-mode call draws from the given generator."""
    cfg, v = jax_tree
    pcfg = PConfig().merge_dict(cfg.to_dict())
    c = pcfg.MODEL.TEMPORAL_MODEL.START_OUT_CHANNELS
    x = _x(1, 1, 16, 16, c, seed=4)
    jm = jdist.DistributionModule(in_channels=c, latent_dim=L * 4,
                                  method='GAUSSIAN')
    hv = init_jax(jm, jnp.asarray(x), seed=2)
    tree = {'params': {**v['params'], 'present_distribution': hv['params']},
            'batch_stats': {**v['batch_stats'],
                            'present_distribution': hv['batch_stats']}}
    model = port(StreamingFlow(pcfg), tree)
    p = apply_jax(jm, hv, jnp.asarray(x))
    want = np.asarray(jdist.distribution_forward(
        jnp.asarray(p), L * 4, 'GAUSSIAN', (16, 16), None))
    with torch.no_grad():
        got = model.distribution_forward(t(x))
    assert_close(got, want, TOL, 'StreamingFlow.distribution_forward')
    model.train()
    with torch.no_grad():
        noisy = model.distribution_forward(
            t(x), generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(noisy, got)
    partial = dict(tree['params'])
    partial['present_distribution'] = {
        k: w for k, w in hv['params'].items() if k != 'decoder'}
    with pytest.raises(KeyError, match='present_distribution'):
        flax_to_state_dict(StreamingFlow(pcfg), {**tree, 'params': partial})


def test_gaussian_head_refuses_the_flagship_state_as_jax_does():
    """Four stride-2 Bottlenecks need a side divisible by 16: at the
    flagship's 200 x 200 the conv path gives 13 where the max pool gives
    12, and both packages refuse it; 192 goes through."""
    x = np.zeros((1, 1, 200, 200, 8), np.float32)
    jm = jdist.DistributionModule(in_channels=8, latent_dim=L)
    with pytest.raises(TypeError, match='incompatible shapes'):
        jax.eval_shape(lambda a: jm.init_with_output(
            jax.random.PRNGKey(0), a), jax.ShapeDtypeStruct(x.shape,
                                                            jnp.float32))
    pm = pdist.DistributionModule(8, L).eval()
    with torch.no_grad(), pytest.raises(RuntimeError, match='size'):
        pm(t(x))
    with torch.no_grad():
        assert tuple(pm(t(x[:, :, :192, :192])).shape) == (1, 1, 2 * L)
