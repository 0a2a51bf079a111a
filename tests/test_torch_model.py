"""The whole slice: the port's eval-mode StreamingFlow forward vs the JAX
package's ``StreamingFlow.apply`` at ``tiny_config`` with camera and LiDAR,
deterministic (PROBABILISTIC off), the same random weights carried across
by the bridge, the same make_batch inputs.

Bar: 5e-3 of each output's scale, the composed-stack bar of the fusion
forward (ROADMAP.md).  ENCODER.OUT_CHANNELS is 64, the width of the main
path and of the patch-pool kernel.
"""
import jax
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.models import StreamingFlow as JStreamingFlow
from streamingflow_tpu.training.trainer import batch_to_model_args as jargs
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.ops import patch_pool as PP

from torch_parity import (apply_jax, assert_close, init_jax, jnp_tree, port,
                          port_like)

TOL = 5e-3


def _cfg():
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.MODALITY.USE_CAMERA = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.PROBABILISTIC.ENABLED = False
    cfg.MODEL.BEV_POOL_BACKEND = 'scatter'
    return cfg


@pytest.fixture(scope='module')
def jax_run():
    cfg = _cfg()
    batch = make_batch(cfg, 1, seed=5, n_points=2048)
    args = jargs(jnp_tree(batch), cfg)
    model = JStreamingFlow(cfg)
    variables = init_jax(model, like=port_like(cfg))
    return cfg, batch, variables, apply_jax(model, variables, **args)


def _port_forward(cfg, batch, variables, backend):
    pcfg = PConfig().merge_dict(cfg.to_dict())
    pcfg.MODEL.BEV_POOL_BACKEND = backend
    model = port(P.build_model(pcfg, device='cpu'), variables)
    with torch.no_grad():
        return model(**P.batch_to_model_args(batch, pcfg, device='cpu'))


def _compare(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        assert np.abs(w).max() > 1e-3, f'{k} is too small to compare'
        assert_close(got[k], w, tol, k)


def test_forward_matches_jax(jax_run):
    cfg, batch, variables, want = jax_run
    _compare(_port_forward(cfg, batch, variables, 'scatter'), want, TOL)


def test_forward_patch_pool_matches_jax_scatter(jax_run):
    """The port's 'pallas_patch' pool (its plain version here) against JAX
    'scatter'.  With no row dropped the two differ only by the bf16
    rounding of the lifted camera features (2^-9 relative per feature),
    which 1e-3 of each output's scale bounds with margin on this input."""
    cfg, batch, variables, want = jax_run
    got = _port_forward(cfg, batch, variables, 'pallas_patch')
    assert int(PP.last_drops.sum()) == 0
    _compare(got, want, 1e-3)
