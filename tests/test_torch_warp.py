"""The port's pose functions and feature warps (streamingflow_tpu_torch/
geometry.py) vs streamingflow_tpu.geometry, on the same numpy inputs.

Bar: 1e-5 of the output's scale for floats; labels warped with 'nearest'
(integers, rounding at .5 and the zero border decide them) must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from streamingflow_tpu import geometry as JG
from streamingflow_tpu_torch import geometry as PG

from torch_parity import assert_close, t

TOL = 1e-5
EXTENT = (8.0, 8.0)


def _flow(rng, b, n):
    flow = np.zeros((b, n, 6), np.float32)
    flow[..., 0] = 1.5 * rng.rand(b, n)
    flow[..., 1] = 0.4 * rng.randn(b, n)
    flow[..., 5] = 0.15 * rng.randn(b, n)
    return flow


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision('highest'):
        return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


def test_mat2pose_vec_and_invert_pose_matrix():
    rng = np.random.RandomState(0)
    vec = rng.randn(3, 4, 6).astype(np.float32) * 0.5
    mat = _jax(JG.pose_vec2mat, vec)
    assert_close(PG.mat2pose_vec(t(mat)), _jax(JG.mat2pose_vec, mat), TOL,
                 'mat2pose_vec')
    assert_close(PG.invert_pose_matrix(t(mat)),
                 _jax(JG.invert_pose_matrix, mat), TOL, 'invert_pose_matrix')
    eye = PG.invert_pose_matrix(t(mat)) @ t(mat)
    assert_close(eye, np.broadcast_to(np.eye(4, dtype=np.float32),
                                      eye.shape), TOL, 'inverse @ pose')


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_grid_sample_2d(mode):
    """Sampling positions inside, on the border, outside, and exactly at .5
    ('nearest' rounds half to even)."""
    rng = np.random.RandomState(1)
    img = rng.randn(2, 6, 7, 3).astype(np.float32)
    ix = np.array([[-1.2, -0.5, 0.0, 0.5, 1.5, 2.5, 5.49, 6.0, 6.5, 7.3]],
                  np.float32) + np.zeros((4, 1), np.float32)
    iy = np.array([[-0.7], [0.5], [2.5], [5.6]], np.float32) + \
        np.zeros((1, 10), np.float32)
    want = np.stack([_jax(JG._grid_sample_2d, img[i], ix, iy, mode=mode)
                     for i in range(2)])
    got = PG._grid_sample_2d(t(img), t(ix).expand(2, -1, -1),
                             t(iy).expand(2, -1, -1), mode)
    assert_close(got, want, TOL, f'_grid_sample_2d {mode}')


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
def test_affine_warp_and_warp_features(mode):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 16, 20, 4).astype(np.float32)
    theta = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (3, 1, 1))
    theta += 0.1 * rng.randn(3, 2, 3).astype(np.float32)
    assert_close(PG.affine_warp(t(x), t(theta), mode),
                 _jax(JG.affine_warp, x, theta, mode=mode), TOL,
                 f'affine_warp {mode}')
    flow = _flow(rng, 3, 1)[:, 0]
    assert_close(
        PG.warp_features(t(x), t(flow), mode, EXTENT),
        _jax(JG.warp_features, x, flow, mode=mode, spatial_extent=EXTENT),
        TOL, f'warp_features {mode}')
    assert PG.warp_features(t(x), None) is not None


def test_identity_warp_returns_the_input():
    x = np.random.RandomState(3).randn(1, 8, 8, 2).astype(np.float32)
    zero = np.zeros((1, 6), np.float32)
    for mode in ('nearest', 'bilinear'):
        got = PG.warp_features(t(x), t(zero), mode, EXTENT)
        assert_close(got, x, 1e-6, f'identity {mode}')


@pytest.mark.parametrize('mode', ['nearest', 'bilinear'])
@pytest.mark.parametrize('reverse', [False, True])
def test_cumulative_warps(mode, reverse):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 16, 16, 3).astype(np.float32)
    flow = _flow(rng, 2, 4)
    name = 'cumulative_warp_features' + ('_reverse' if reverse else '')
    want = _jax(getattr(JG, name), x, flow, mode=mode, spatial_extent=EXTENT)
    got = getattr(PG, name)(t(x), t(flow), mode, EXTENT)
    assert_close(got, want, TOL, f'{name} {mode}')


def test_cumulative_warp_of_one_frame_is_the_frame():
    x = np.ones((1, 1, 4, 4, 1), np.float32)
    got = PG.cumulative_warp_features(t(x), t(np.zeros((1, 1, 6), np.float32)),
                                      'nearest', EXTENT)
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize('reverse', [False, True])
def test_warped_integer_labels_are_equal(reverse):
    """Instance ids warped with 'nearest' come out as the same integers."""
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 6, (2, 4, 32, 32, 1)).astype(np.float32)
    flow = _flow(rng, 2, 4)
    name = 'cumulative_warp_features' + ('_reverse' if reverse else '')
    want = _jax(getattr(JG, name), labels, flow, mode='nearest',
                spatial_extent=EXTENT).astype(np.int32)
    got = getattr(PG, name)(t(labels), t(flow), 'nearest',
                            EXTENT).to(t(want).dtype)
    assert want.any() and (want == 0).any()
    np.testing.assert_array_equal(got.numpy(), want)
