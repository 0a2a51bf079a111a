"""Per-module parity of the PyTorch port's forecast stack with the JAX
package: conv-GRU cells, the GRU-ODE event tape and FuturePredictionODE.

JAX runs on the CPU at full fp32 matmul precision, the port in fp32 on the
CPU, with random JAX variables (tests/torch_parity.py) carried across by
the port's bridge.  Bar: 1e-5 of the output's scale for one cell and for
the deterministic tape (the JAX package's single-module and one-ODE-step
tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.layers import ode as jode
from streamingflow_tpu.layers import temporal as jtemporal
from streamingflow_tpu.models import future_prediction as jfp
from streamingflow_tpu_torch.layers import ode as pode
from streamingflow_tpu_torch.layers import temporal as ptemporal
from streamingflow_tpu_torch.models import future_prediction as pfp

from torch_parity import (apply_jax, assert_close, init_jax, nchw, nhwc,
                          port, seq, t)

TOL = 1e-5
RNG = np.random.RandomState(1)


def _randn(*shape):
    return RNG.randn(*shape).astype(np.float32)


@pytest.mark.parametrize('return_delta', [True, False])
def test_dual_gru_cell(return_delta):
    x, s = _randn(2, 8, 8, 6), _randn(2, 8, 8, 8)
    jm = jtemporal.DualGRUCell(6, 8, return_delta=return_delta)
    v = init_jax(jm, jnp.asarray(x), jnp.asarray(s))
    want = apply_jax(jm, v, jnp.asarray(x), jnp.asarray(s))
    pm = port(ptemporal.DualGRUCell(6, 8, return_delta), v)
    with torch.no_grad():
        got = pm(nchw(x), nchw(s))
    assert_close(nhwc(got), want, TOL, 'DualGRUCell')


def test_spatial_gru():
    x, s = _randn(2, 3, 8, 8, 6), _randn(2, 8, 8, 8)
    jm = jtemporal.SpatialGRU(input_size=6, hidden_size=8)
    v = init_jax(jm, jnp.asarray(x), jnp.asarray(s))
    want = apply_jax(jm, v, jnp.asarray(x), jnp.asarray(s))
    pm = port(ptemporal.SpatialGRU(6, 6, 8), v)
    with torch.no_grad():
        got = pm(seq(x), nchw(s))
    assert_close(nhwc(got), want, TOL, 'SpatialGRU')


def test_softplus_rsample_with_jax_noise():
    raw = _randn(2, 4, 4, 6)
    key = jax.random.PRNGKey(3)
    want = jode.softplus_rsample(jnp.asarray(raw), key)
    noise = jax.random.normal(key, raw[..., :3].shape, jnp.float32)
    got = pode.softplus_rsample(nchw(raw), nchw(np.asarray(noise)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(nhwc(pode.softplus_rsample(nchw(raw))),
                                  raw[..., :3])


def _times():
    # two samples with different timelines: per-sample masks matter
    obs_t = np.array([[-1.0, -0.6, -0.5, -0.25, 0.0],
                      [-0.8, -0.8, -0.5, -0.1, 0.0]], np.float32)
    tgt_t = np.array([[-0.5, 0.0, 0.5, 1.0],
                      [-0.5, 0.0, 0.25, 1.0]], np.float32)
    return obs_t, tgt_t


@pytest.mark.parametrize('solver,variable,impute', [
    ('euler', True, True), ('midpoint', False, False)])
def test_gru_ode_bayes_deterministic(solver, variable, impute):
    obs_t, tgt_t = _times()
    obs = _randn(2, obs_t.shape[1], 16, 16, 8)
    inp = _randn(2, 1, 16, 16, 8)
    kw = dict(delta_t=0.05, solver=solver, impute=impute,
              variable_step=variable, srvp_filter_size=4,
              max_gap_seconds=0.2, stochastic=False)
    jm = jode.GRUODEBayes(input_size=8, hidden_size=8, **kw)
    args = tuple(jnp.asarray(a) for a in (obs_t, obs, inp, tgt_t))
    v = init_jax(jm, *args)
    want = apply_jax(jm, v, *args)
    pm = port(pode.GRUODEBayes(8, 8, **kw), v)
    with torch.no_grad():
        got = pm(t(obs_t), seq(obs), seq(inp), t(tgt_t))
    assert_close(nhwc(got), want, TOL, f'GRUODEBayes {solver}')


def test_merge_observations_stable():
    cam_t = np.array([[-0.5, 0.0]], np.float32)
    lid_t = np.array([[-0.5, -0.2, 0.0]], np.float32)
    cam, lid = _randn(1, 2, 4, 4, 3), _randn(1, 3, 4, 4, 3)
    wt, ws = jfp.merge_observations(jnp.asarray(cam), jnp.asarray(cam_t),
                                    jnp.asarray(lid), jnp.asarray(lid_t))
    gt, gs = pfp.merge_observations(seq(cam), t(cam_t), seq(lid), t(lid_t))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(nhwc(gs), np.asarray(ws))


def test_future_prediction_ode():
    cam_t = np.array([[-1.0, -0.5, 0.0]], np.float32)
    lid_t = np.array([[-0.8, -0.4, 0.0]], np.float32)
    tgt_t = np.array([[-1.0, -0.5, 0.0, 0.5, 1.0]], np.float32)
    cam, lid = _randn(1, 3, 16, 16, 8), _randn(1, 3, 16, 16, 8)
    present = cam[:, -1:]
    kw = dict(in_channels=8, latent_dim=8, srvp_filter_size=4,
              variable_step=True, impute=True, stochastic=False)
    jm = jfp.FuturePredictionODE(**kw)
    args = tuple(jnp.asarray(a) for a in (present, cam, cam_t, lid, lid_t,
                                          tgt_t))
    v = init_jax(jm, *args)
    want = apply_jax(jm, v, *args)
    pm = port(pfp.FuturePredictionODE(**kw), v)
    with torch.no_grad():
        got = pm(seq(present), seq(cam), t(cam_t), seq(lid), t(lid_t),
                 t(tgt_t))
    assert_close(nhwc(got), want, TOL, 'FuturePredictionODE')
