"""The port's weight bridge (streamingflow_tpu_torch/convert.py): a JAX
StreamingFlow variable tree at tiny_config with camera, LiDAR and the
probabilistic GRU-ODE converts with every leaf consumed and every torch
parameter and buffer assigned, and a tree with a leaf missing or one too
many is refused."""
import copy

import jax
import numpy as np
import pytest
import torch

from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.layers import conv as jconv
from streamingflow_tpu.models import StreamingFlow as JStreamingFlow
from streamingflow_tpu.training.trainer import batch_to_model_args as jargs
import streamingflow_tpu_torch as P
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.convert import flatten, flax_to_state_dict
from streamingflow_tpu_torch.layers import conv as pconv

from torch_parity import init_jax, jnp_tree


@pytest.fixture(scope='module')
def tree_and_model():
    cfg = tiny_config()
    cfg.MODEL.MODALITY.USE_LIDAR = True
    cfg.PROBABILISTIC.ENABLED = True
    variables = init_jax(JStreamingFlow(cfg),
                         **jargs(jnp_tree(make_batch(cfg, 1, n_points=256)),
                                 cfg))
    model = P.build_model(PConfig().merge_dict(cfg.to_dict()), device='cpu')
    return variables, model


def test_every_leaf_consumed_every_tensor_assigned(tree_and_model):
    variables, model = tree_and_model
    sd = flax_to_state_dict(model, variables)
    assert set(sd) == set(model.state_dict())
    n_leaves = sum(len(flatten(variables[c])) for c in variables)
    n_tracked = sum(k.endswith('num_batches_tracked') for k in sd)
    # the distribution head, which init never calls, keeps the model's own
    # values: its tensors have no leaf (convert.py)
    n_head = sum(k.startswith('present_distribution.')
                 and not k.endswith('num_batches_tracked') for k in sd)
    assert 'present_distribution' not in variables['params'] and n_head
    assert len(sd) - n_tracked - n_head == n_leaves
    model.load_state_dict(sd, strict=True)
    # BN eps follows the flax module: 1e-3 in EfficientNet and the pillar
    # ladder, 1e-5 elsewhere
    assert model.encoder.backbone.BatchNorm_0.eps == 1e-3
    assert model.lidar_encoder.stage3_conv1.BatchNorm_0.eps == 1e-3
    assert model.decoder.BatchNorm_0.eps == 1e-5


def test_layouts_by_rule(tree_and_model):
    variables, model = tree_and_model
    sd = flax_to_state_dict(model, variables)
    p = variables['params']
    k = p['encoder']['backbone']['block_1']['depthwise_conv']['kernel']
    np.testing.assert_array_equal(
        sd['encoder.backbone.block_1.depthwise_conv.weight'].numpy(),
        np.transpose(k, (3, 2, 0, 1)))
    k3 = p['temporal_model']['TemporalBlock_0']['CausalConv3d_0']['Conv_0'][
        'kernel']
    np.testing.assert_array_equal(
        sd['temporal_model.TemporalBlock_0.CausalConv3d_0.Conv_0.weight']
        .numpy(), np.transpose(k3, (4, 3, 0, 1, 2)))
    dense = p['future_prediction']['res_block_0_0']['Dense_0']['kernel']
    np.testing.assert_array_equal(
        sd['future_prediction.res_block_0_0.Dense_0.weight'].numpy(),
        dense.T)
    gates = p['future_prediction']['spatial_gru_0']['GRUGates_0'][
        'gates_kernel']
    np.testing.assert_array_equal(
        sd['future_prediction.spatial_gru_0.GRUGates_0.gates_kernel']
        .numpy(), np.transpose(gates, (3, 2, 0, 1)))
    stats = variables['batch_stats']['decoder']['BatchNorm_0']
    np.testing.assert_array_equal(
        sd['decoder.BatchNorm_0.running_var'].numpy(), stats['var'])


def test_missing_leaf_raises(tree_and_model):
    variables, model = tree_and_model
    broken = copy.deepcopy(variables)
    del broken['params']['decoder']['first_conv']['kernel']
    with pytest.raises(KeyError, match='decoder/first_conv/kernel'):
        flax_to_state_dict(model, broken)


def test_extra_leaf_raises(tree_and_model):
    variables, model = tree_and_model
    extra = copy.deepcopy(variables)
    extra['params']['decoder']['stray'] = {'kernel': np.zeros((1, 1, 2, 2),
                                                              np.float32)}
    with pytest.raises(KeyError, match='decoder/stray/kernel'):
        flax_to_state_dict(model, extra)


def test_conv_block_transpose_is_stride1_conv():
    """The flax ConvBlock's stride-1 ConvTranspose (symmetric padding) and
    the port's plain conv agree on the same kernel."""
    from torch_parity import apply_jax, nchw, nhwc, port
    x = np.random.RandomState(0).randn(2, 6, 6, 4).astype(np.float32)
    jm = jconv.ConvBlock(5, transpose=True, activation='lrelu', bias=True,
                         norm='none')
    v = init_jax(jm, jax.numpy.asarray(x))
    want = apply_jax(jm, v, jax.numpy.asarray(x))
    pm = port(pconv.ConvBlock(4, 5, transpose=True, activation='lrelu',
                              bias=True, norm='none'), v)
    with torch.no_grad():
        got = pm(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)
