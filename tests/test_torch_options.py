"""The off-default options of the port's modules against the JAX package:
``ConvBlock`` with instance norm and as a strided transposed conv,
``BiGRU``, the SRVP encoder's skips into its decoder, the GRU-ODE with
``skipco``, and ``TEMPORAL_MODEL.NAME='identity'`` alone and in a tiny
model.

Bars: 1e-5 of the output's scale for one module (the JAX package's
single-module bar), 5e-3 for the tiny model's forward (the fusion
forward's composed-stack bar).  Shapes are tiny_config's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.layers import conv as jconv
from streamingflow_tpu.layers import ode as jode
from streamingflow_tpu.layers import srvp as jsrvp
from streamingflow_tpu.layers import temporal as jtemporal
from streamingflow_tpu.models import StreamingFlow as JStreamingFlow
from streamingflow_tpu.models import temporal_model as jtm
from streamingflow_tpu.training.trainer import batch_to_model_args as jargs
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.layers import conv as pconv
from streamingflow_tpu_torch.layers import ode as pode
from streamingflow_tpu_torch.layers import srvp as psrvp
from streamingflow_tpu_torch.layers import temporal as ptemporal
from streamingflow_tpu_torch.models import temporal_model as ptm

from torch_parity import (apply_jax, assert_close, init_jax, jnp_tree, nchw,
                          nhwc, port, seq, t)

TOL = 1e-5
RNG = np.random.RandomState(7)


def _randn(*shape):
    return RNG.randn(*shape).astype(np.float32)


class _InstanceNormConvBlock(nn.Module):
    """The JAX ConvBlock(norm='in') as its make_norm means it: conv, then
    flax GroupNorm with one channel a group (scale, bias, eps 1e-5), then
    ReLU, under the same variable names.  make_norm itself passes
    ``group_size=1`` beside flax's default ``num_groups=32``, which the
    installed flax refuses (pinned below)."""
    out_channels: int
    transpose: bool = False

    @nn.compact
    def __call__(self, x):
        conv = nn.ConvTranspose if self.transpose else nn.Conv
        x = conv(self.out_channels, (3, 3), padding=[(1, 1)] * 2,
                 use_bias=False)(x)
        x = nn.GroupNorm(num_groups=None, group_size=1, epsilon=1e-5)(x)
        return nn.relu(x)


def test_jax_make_norm_in_raises_under_this_flax():
    x = jnp.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError, match='num_groups'):
        jconv.ConvBlock(6, norm='in').init(jax.random.PRNGKey(0), x)


@pytest.mark.parametrize('transpose', [False, True])
def test_conv_block_instance_norm(transpose):
    x = _randn(2, 8, 8, 4)
    jm = _InstanceNormConvBlock(6, transpose=transpose)
    v = init_jax(jm, jnp.asarray(x))
    assert set(v['params']) == {'ConvTranspose_0' if transpose else 'Conv_0',
                                'GroupNorm_0'}
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(pconv.ConvBlock(4, 6, norm='in', transpose=transpose), v)
    with torch.no_grad():
        got = pm(nchw(x))
    assert_close(nhwc(got), want, TOL, 'ConvBlock in')


@pytest.mark.parametrize('k,stride,bias', [(3, 2, False), (3, 2, True),
                                           (5, 2, False), (3, 3, True)])
def test_strided_transposed_conv_block(k, stride, bias):
    """The flax ConvTranspose of stride s, padding (k//2, k//2): the
    zero-dilated input correlated, (H - 1) s + 1 + 2 (k//2) - k + 1 rows
    (2H - 1 for k 3, s 2)."""
    x = _randn(2, 5, 7, 4)
    jm = jconv.ConvBlock(6, kernel_size=k, stride=stride, transpose=True,
                         bias=bias, activation='lrelu')
    v = init_jax(jm, jnp.asarray(x))
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(pconv.ConvBlock(4, 6, k, stride=stride, transpose=True,
                              bias=bias, activation='lrelu'), v)
    with torch.no_grad():
        got = pm(nchw(x))
    rows = [(n - 1) * stride + 1 + 2 * (k // 2) - k + 1 for n in (5, 7)]
    assert list(got.shape[2:]) == rows == list(want.shape[1:3])
    assert_close(nhwc(got), want, TOL, 'strided transposed ConvBlock')


def test_bigru():
    x = _randn(2, 3, 8, 8, 6)
    jm = jtemporal.BiGRU(in_channels=6)
    v = init_jax(jm, jnp.asarray(x))
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(ptemporal.BiGRU(6), v)
    with torch.no_grad():
        got = pm(seq(x))
    assert_close(nhwc(got), want, TOL, 'BiGRU')


def test_small_encoder_decoder_with_skips():
    x = _randn(2, 16, 16, 6)
    enc = jsrvp.SmallEncoder(nh=6, nf=4)
    ve = init_jax(enc, jnp.asarray(x), return_skip=True)
    want_h, want_skips = apply_jax(enc, ve, jnp.asarray(x), return_skip=True)
    pe = port(psrvp.SmallEncoder(6, 6, 4), ve)
    with torch.no_grad():
        h, skips = pe(nchw(x), return_skip=True)
        assert torch.equal(pe(nchw(x)), h)
    assert_close(nhwc(h), want_h, TOL, 'SmallEncoder')
    assert len(skips) == len(want_skips) == 5
    for i, (g, w) in enumerate(zip(skips, want_skips)):
        assert_close(nhwc(g), w, TOL, f'skip {i}')

    dec = jsrvp.SmallDecoder(nh=6, nf=4, skip=True)
    jskips = [jnp.asarray(s) for s in want_skips]
    vd = init_jax(dec, jnp.asarray(want_h), jskips)
    want = apply_jax(dec, vd, jnp.asarray(want_h), jskips)
    pd = port(psrvp.SmallDecoder(6, 6, 4, skip=True), vd)
    with torch.no_grad():
        got = pd(nchw(want_h), [nchw(s) for s in want_skips])
        with pytest.raises(ValueError, match='without encoder skips'):
            pd(nchw(want_h))
    assert_close(nhwc(got), want, TOL, 'SmallDecoder skip')


def test_gru_ode_skipco_refuses_as_the_jax_module_does():
    """The JAX GRU-ODE builds its decoder for skips but its tape hands it
    none, so any call (init included) fails on SmallDecoder's assertion;
    the port's builds and refuses its first forward (one observation, one
    target) the same way."""
    obs_t = np.array([[-0.5]], np.float32)
    tgt_t = np.array([[0.5]], np.float32)
    obs, inp = _randn(1, 1, 16, 16, 8), _randn(1, 1, 16, 16, 8)
    kw = dict(delta_t=0.05, variable_step=True, srvp_filter_size=4,
              stochastic=False, skipco=True)
    jm = jode.GRUODEBayes(input_size=8, hidden_size=8, **kw)
    args = tuple(jnp.asarray(a) for a in (obs_t, obs, inp, tgt_t))
    with pytest.raises(AssertionError):
        init_jax(jm, *args)
    pm = pode.GRUODEBayes(8, 8, **kw).eval()
    assert pm.srvp_decoder.skip
    with torch.no_grad(), pytest.raises(ValueError, match='skips'):
        pm(t(obs_t), seq(obs), seq(inp), t(tgt_t))


def test_temporal_model_identity():
    x = _randn(1, 2, 8, 8, 5)
    jm = jtm.TemporalModelIdentity()
    want = apply_jax(jm, {}, jnp.asarray(x))
    got = ptm.TemporalModelIdentity()(seq(x))
    np.testing.assert_array_equal(nhwc(got), want)


def test_identity_temporal_model_in_the_model():
    cfg = tiny_config()
    cfg.MODEL.TEMPORAL_MODEL.NAME = 'identity'
    cfg.MODEL.TEMPORAL_MODEL.INPUT_EGOPOSE = False
    cfg.PROBABILISTIC.ENABLED = False
    cfg.MODEL.BEV_POOL_BACKEND = 'scatter'
    batch = make_batch(cfg, 1, seed=3, n_points=256)
    args = jargs(jnp_tree(batch), cfg)
    jm = JStreamingFlow(cfg)
    v = init_jax(jm, **args)
    assert 'temporal_model' not in v['params']
    want = apply_jax(jm, v, **args)
    pcfg = PConfig().merge_dict(cfg.to_dict())
    model = port(P.build_model(pcfg, device='cpu'), v)
    assert isinstance(model.temporal_model, ptm.TemporalModelIdentity)
    with torch.no_grad():
        got = model(**P.batch_to_model_args(batch, pcfg, device='cpu'))
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        assert_close(got[k], w, 5e-3, k)
