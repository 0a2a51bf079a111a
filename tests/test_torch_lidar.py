"""The port's spconv8x backbone (streamingflow_tpu_torch/models/
lidar_encoder.py) against the JAX package's on the CPU: MaskedBatchNorm in
both layouts, the column-engine LidarBEVEncoder with Z_FORMULATION
'winfuse' (interpret-mode Pallas kernel on the JAX side, the plain version
of K3 on the port's), and the whole camera + spconv8x StreamingFlow.

Bars: 1e-5 for one BN, 1e-4 of the output's scale for the encoder, 5e-3 of
each output's scale for the model (the composed-stack bar of ROADMAP.md).
The model test shrinks COLUMN_CAPS and the window plan (tiny_config keeps
the flagship caps, 65536 slots a cloud).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from streamingflow_tpu.config import Config as JConfig
from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.models import StreamingFlow as JStreamingFlow
from streamingflow_tpu.models import lidar_encoder as JL
from streamingflow_tpu.training.trainer import batch_to_model_args as jargs
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import flatten, flax_to_state_dict
from streamingflow_tpu_torch.data import flagship_config
from streamingflow_tpu_torch.models import lidar_encoder as PL
from streamingflow_tpu_torch.ops import patch_pool as PP

from torch_parity import (apply_jax, assert_close, init_jax, jnp_tree, port,
                          t)


def _port_se(jse):
    d = {'MODEL': {'SPARSE_ENCODER': dataclasses.asdict(jse)}}
    return PConfig().merge_dict(d).MODEL.SPARSE_ENCODER


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('layout', ['fused', 'dense'])
def test_masked_batch_norm_matches_jax(layout, dtype):
    """Eval mode, normalised in the input's type; bf16 to one bf16 step."""
    rng = np.random.default_rng(0)
    c, nz = 6, 5
    if layout == 'fused':
        x = rng.normal(size=(2, 40, nz * c))
        mask = rng.random((2, 40, nz)) > 0.4
    else:
        x = rng.normal(size=(2, 4, 3, nz, c))
        mask = rng.random((2, 4, 3, nz)) > 0.4
    x = x.astype(np.float32)
    jdt = jnp.dtype(dtype)
    module = JL.MaskedBatchNorm()
    variables = init_jax(module, jnp.asarray(x), jnp.asarray(mask))
    want = apply_jax(module, variables, jnp.asarray(x, jdt),
                     jnp.asarray(mask))
    bn = port(PL.MaskedBatchNorm(c), variables)
    xt = t(x).to(getattr(torch, dtype))
    if layout == 'dense':             # the port's grids are channel first
        xt = xt.permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = bn(xt, t(mask))
    if layout == 'dense':
        got = got.permute(0, 2, 3, 4, 1)
    assert got.dtype == xt.dtype
    assert_close(got, want, 1e-5 if dtype == 'float32' else 2 ** -7, layout)


def _micro_se(formulation='winfuse'):
    """The micro ladder of tests/test_winfuse.py."""
    cfg = JConfig().MODEL.SPARSE_ENCODER
    cfg.POINT_CLOUD_RANGE = [-4.0, -4.0, -4.0, 4.0, 4.0, 3.68]
    cfg.VOXEL_SIZE = [0.25, 0.25, 0.32]
    cfg.SPARSE_SHAPE = (32, 32, 25)
    cfg.MAX_VOXELS = 512
    cfg.STAGE_CAPS = [512, 256, 128, 64]
    cfg.COLUMN_CAPS = [256, 128, 64, 64]
    cfg.ENGINE = 'column'
    cfg.Z_FORMULATION = formulation
    cfg.WINDOW_BLOCK = 16
    cfg.WINFUSE_WINDOW = 64
    cfg.DENSE_TAIL_FROM_STAGE = 3
    return cfg


def test_lidar_encoder_matches_jax():
    cfg = _micro_se()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-4, 4, size=(1, 2, 256, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-4, 3.5, size=(1, 2, 256))
    module = JL.LidarBEVEncoder(cfg)
    enc = PL.LidarBEVEncoder(_port_se(cfg))
    variables = init_jax(module, like=enc)
    want = apply_jax(module, variables, jnp.asarray(pts))
    enc = port(enc, variables)
    with torch.no_grad():
        got = enc(t(pts))
    assert got.shape[2] == enc.out_channels
    assert_close(got.permute(0, 1, 3, 4, 2), want, 1e-4, 'encoder')
    assert float(np.abs(want).max()) > 1e-2
    assert [int(v.sum()) for v in enc.last_n_dropped.values()] == [0, 0]


def test_flagship_encoder_converts_completely():
    """The flagship spconv8x encoder's JAX variable tree (shapes from
    eval_shape) maps onto the port's module, every leaf consumed, every
    tensor assigned, the tap weights kept in (taps, Cin, Cout)."""
    pcfg = flagship_config(backbone='spconv8x')
    assert pcfg.MODEL.LIDAR.BACKBONE == 'spconv8x'
    jse = JConfig().merge_dict(pcfg.to_dict()).MODEL.SPARSE_ENCODER
    pts = np.zeros((1, 1, 64, 5), np.float32)
    pts[..., :3] = 1.0
    variables = init_jax(JL.LidarBEVEncoder(jse), jnp.asarray(pts))
    enc = PL.LidarBEVEncoder(pcfg.MODEL.SPARSE_ENCODER)
    sd = flax_to_state_dict(enc, variables)
    n_tracked = sum(k.endswith('num_batches_tracked') for k in sd)
    assert len(sd) - n_tracked == sum(len(flatten(v))
                                      for v in variables.values())
    p = variables['params']
    np.testing.assert_array_equal(sd['stage2_block1.kernel2'].numpy(),
                                  p['stage2_block1']['kernel2'])
    assert tuple(sd['down1.kernel'].shape) == (27, 16, 32)
    assert enc.out_channels == 256


def _model_cfg():
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.MODEL.ENCODER.OUT_CHANNELS = 64
    cfg.PROBABILISTIC.ENABLED = False
    cfg.MODEL.BEV_POOL_BACKEND = 'scatter'
    cfg.MODEL.LIDAR.BACKBONE = 'spconv8x'
    se = cfg.MODEL.SPARSE_ENCODER
    se.ENGINE = 'column'
    se.Z_FORMULATION = 'winfuse'
    se.DENSE_TAIL_FROM_STAGE = 3
    se.COLUMN_CAPS = [512, 768, 512, 256]
    se.WINDOW_BLOCK = 16
    se.WINFUSE_WINDOW = 64
    return cfg


def test_spconv8x_forward_matches_jax():
    """Camera + spconv8x/winfuse StreamingFlow, the port's plain versions
    of K2 ('pallas_patch', no row dropped) and K3 against JAX 'scatter' and
    the interpret-mode winfuse kernel."""
    cfg = _model_cfg()
    batch = make_batch(cfg, 1, seed=5, n_points=512)
    args = jargs(jnp_tree(batch), cfg)
    model = JStreamingFlow(cfg)
    pcfg = PConfig().merge_dict(cfg.to_dict())
    pcfg.MODEL.BEV_POOL_BACKEND = 'pallas_patch'
    pmodel = P.build_model(pcfg, device='cpu')
    variables = init_jax(model, like=pmodel)
    want = apply_jax(model, variables, **args)
    pmodel = port(pmodel, variables)
    with torch.no_grad():
        got = pmodel(**P.batch_to_model_args(batch, pcfg, device='cpu'))
    assert int(PP.last_drops.sum()) == 0
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        assert np.abs(w).max() > 1e-3, f'{k} is too small to compare'
        assert_close(got[k], w, 5e-3, k)
