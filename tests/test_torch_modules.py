"""Per-module parity of the PyTorch port with the JAX package: encoders,
temporal model, decoder, geometry and the lift-splat projection.

Each JAX module gets random variables (tests/torch_parity.py), carried
across by the port's bridge, and both run the same numpy input in fp32 on
the CPU.  Bar: the JAX package's own single-module tolerance, 1e-5 of
the output's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu import geometry as JG
from streamingflow_tpu.data import make_batch, tiny_config
from streamingflow_tpu.layers import conv as jconv
from streamingflow_tpu.layers import temporal as jtemporal
from streamingflow_tpu.models import decoder as jdec
from streamingflow_tpu.models import encoder as jenc
from streamingflow_tpu.models import pillar_encoder as jpe
from streamingflow_tpu.models import temporal_model as jtm
from streamingflow_tpu.ops import lift_splat as JLS
from streamingflow_tpu_torch import geometry as PG
from streamingflow_tpu_torch.layers import conv as pconv
from streamingflow_tpu_torch.layers import temporal as ptemporal
from streamingflow_tpu_torch.models import decoder as pdec
from streamingflow_tpu_torch.models import encoder as penc
from streamingflow_tpu_torch.models import pillar_encoder as ppe
from streamingflow_tpu_torch.models import temporal_model as ptm
from streamingflow_tpu_torch.ops import lift_splat as PLS

from torch_parity import (apply_jax, assert_close, init_jax, nchw, nhwc,
                          port, seq, t)

TOL = 1e-5
RNG = np.random.RandomState(0)


def _randn(*shape):
    return RNG.randn(*shape).astype(np.float32)


def test_pillar_encoder():
    cfg = tiny_config()
    se = cfg.MODEL.SPARSE_ENCODER
    pts = make_batch(cfg, 1, seed=2, n_points=1024)['points'][:, :2]
    jm = jpe.PillarBEVEncoder(se, tile_sorted=True)
    v = init_jax(jm, jnp.asarray(pts))
    want = apply_jax(jm, v, jnp.asarray(pts))
    pm = port(ppe.PillarBEVEncoder(se, tile_sorted=True), v)
    with torch.no_grad():
        got = pm(t(pts))
    # 1e-4: the stage-3 conv sums 2160 terms of raw pillar statistics
    # (metre-scale means, z^2 up to ~16), so fp32 reassociation error,
    # relative to those inputs, reaches a few 1e-5 of the output's scale
    assert_close(nhwc(got), want, 1e-4, 'PillarBEVEncoder')


def test_encoder_b0():
    x = _randn(2, 32, 64, 3)
    jm = jenc.Encoder(out_channels=16, depth_channels=8,
                      backbone_name='efficientnet-b0')
    v = init_jax(jm, jnp.asarray(x))
    want_f, want_d = apply_jax(jm, v, jnp.asarray(x))
    pm = port(penc.Encoder(16, 8, 'efficientnet-b0'), v)
    with torch.no_grad():
        got_f, got_d = pm(nchw(x))
    assert_close(nhwc(got_f), want_f, TOL, 'Encoder feature')
    assert_close(nhwc(got_d), want_d, TOL, 'Encoder depth')


def test_temporal_model():
    x = _randn(1, 3, 16, 16, 22)
    jm = jtm.TemporalModel(receptive_field=3, input_shape=(16, 16),
                           start_out_channels=16)
    v = init_jax(jm, jnp.asarray(x))
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(ptm.TemporalModel(22, 3, (16, 16), 16), v)
    with torch.no_grad():
        got = pm(seq(x))
    assert_close(nhwc(got), want, TOL, 'TemporalModel')


def test_bottleneck3d():
    x = _randn(1, 3, 8, 8, 16)
    jm = jtemporal.Bottleneck3D(out_channels=24)
    v = init_jax(jm, jnp.asarray(x))
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(ptemporal.Bottleneck3D(16, 24), v)
    with torch.no_grad():
        got = pm(t(x).permute(0, 4, 1, 2, 3))
    assert_close(got.permute(0, 2, 3, 4, 1), want, TOL, 'Bottleneck3D')


def test_decoder_all_heads():
    x = _randn(1, 3, 32, 32, 16)
    kw = dict(n_classes=2, n_present=2, n_hdmap=2, predict_pedestrian=True,
              perceive_hdmap=True, predict_instance=True,
              predict_future_flow=True, planning=True)
    jm = jdec.Decoder(**kw)
    v = init_jax(jm, jnp.asarray(x))
    want = apply_jax(jm, v, jnp.asarray(x))
    pm = port(pdec.Decoder(16, **kw), v)
    with torch.no_grad():
        got = pm(seq(x))
    for k, w in want.items():
        g = got[k]
        g = g if k == 'costvolume' else g.movedim(-3, -1)
        assert_close(g, w, TOL, f'Decoder {k}')


@pytest.mark.parametrize('factor', [2, 4])
def test_resize_matches_jax_image_resize(factor):
    """Bilinear (and the 1x1 -> HxW broadcast of pyramid pooling) and
    nearest resize at the model's integer upsampling factors."""
    x = _randn(2, 5, 6, 3)
    out_hw = (5 * factor, 6 * factor)
    for mode, fn in (('bilinear', pconv.resize_bilinear),
                     ('nearest', pconv.resize_nearest)):
        want = jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), mode)
        assert_close(nhwc(fn(nchw(x), out_hw)), want, TOL, mode)
    one = _randn(2, 1, 1, 3)
    want = jconv.resize_bilinear(jnp.asarray(one), (7, 9))
    assert_close(nhwc(pconv.resize_bilinear(nchw(one), (7, 9))), want, TOL)


def test_geometry():
    cfg = tiny_config()
    b = make_batch(cfg, 2, seed=1)
    frustum = JG.create_frustum(cfg.IMAGE.FINAL_DIM, 8, cfg.LIFT.D_BOUND)
    np.testing.assert_array_equal(
        PG.create_frustum(cfg.IMAGE.FINAL_DIM, 8, cfg.LIFT.D_BOUND), frustum)
    intr, extr = b['intrinsics'][:, 0], b['extrinsics'][:, 0]
    with jax.default_matmul_precision('highest'):
        want = JG.get_geometry(jnp.asarray(frustum), jnp.asarray(intr),
                               jnp.asarray(extr))
        want_pose = JG.pose_vec2mat(jnp.asarray(b['future_egomotion']))
    got = PG.get_geometry(t(frustum), t(intr), t(extr))
    assert_close(got, want, TOL, 'get_geometry')
    assert_close(PG.pose_vec2mat(t(b['future_egomotion'])), want_pose, TOL,
                 'pose_vec2mat')
    for a, w in zip(PG.calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND),
            JG.calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)):
        np.testing.assert_array_equal(a, w)


def _projection_inputs(c):
    cfg = tiny_config()
    b = make_batch(cfg, 1, seed=4)
    s = cfg.TIME_RECEPTIVE_FIELD
    frustum = JG.create_frustum(cfg.IMAGE.FINAL_DIM, 8, cfg.LIFT.D_BOUND)
    n = len(cfg.IMAGE.NAMES)
    with jax.default_matmul_precision('highest'):
        geom = np.asarray(JG.get_geometry(
            jnp.asarray(frustum),
            jnp.asarray(b['intrinsics'][:, :s].reshape(s, n, 3, 3)),
            jnp.asarray(b['extrinsics'][:, :s].reshape(s, n, 4, 4))))
    geom = geom.reshape(1, s, *geom.shape[1:])
    x = _randn(*geom.shape[:-1], c)
    ego = b['future_egomotion'][:, :s]
    params = JG.calculate_birds_eye_view_parameters(
        cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
    return x, geom, ego, params


def _jax_projection(x, geom, ego, params):
    res, start, dim = params
    with jax.default_matmul_precision('highest'):
        mat = JG.pose_vec2mat(jnp.asarray(ego))
        return np.asarray(JLS.projection_to_birds_eye_view(
            jnp.asarray(x), jnp.asarray(geom), mat, start, res, dim,
            discount=0.5, backend='scatter'))


@pytest.mark.parametrize('backend', ['scatter', 'sorted'])
def test_projection_to_birds_eye_view(backend):
    x, geom, ego, params = _projection_inputs(16)
    want = _jax_projection(x, geom, ego, params)
    res, start, dim = params
    got = PLS.projection_to_birds_eye_view(
        t(x), t(geom), PG.pose_vec2mat(t(ego)), start, res, dim,
        discount=0.5, backend=backend)
    assert_close(got, want, TOL, f'projection {backend}')


def test_projection_patch_pool_plain_matches_scatter():
    """'pallas_patch' (its plain version on the CPU) equals the JAX scatter
    pool of the same bf16-rounded features when no row drops."""
    from streamingflow_tpu_torch.ops import patch_pool as PP
    x, geom, ego, params = _projection_inputs(16)
    xq = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = _jax_projection(xq, geom, ego, params)
    res, start, dim = params
    got = PLS.projection_to_birds_eye_view(
        t(x), t(geom), PG.pose_vec2mat(t(ego)), start, res, dim,
        discount=0.5, backend='pallas_patch')
    assert int(PP.last_drops.sum()) == 0
    assert_close(got, want, TOL, 'projection pallas_patch')
