"""Port's bin-sum (streamingflow_tpu_torch/ops/bin_sum.py) vs the JAX one.

On the CPU the wrapper takes its plain PyTorch version, which is held here
against streamingflow_tpu's Pallas kernel in interpret mode and against its
XLA segment-sum fallback, at the JAX package's own bin-sum tolerance
(rtol 1e-5 / atol 1e-4, tests/test_pallas_bin.py).  The CUDA kernel is
held against this plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.models import pillar_encoder as jpe
from streamingflow_tpu.ops.pallas_bin import BINS_PER_TILE, bin_sum as jbin
from streamingflow_tpu_torch.models import pillar_encoder as ppe
from streamingflow_tpu_torch.ops import bin_sum as B

from torch_parity import t

RNG = np.random.default_rng(0)
TOL = dict(rtol=1e-5, atol=1e-4)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else \
        np.asarray(x).astype(np.float32)


@pytest.mark.parametrize('n_bins', [100, BINS_PER_TILE,
                                    3 * BINS_PER_TILE + 7])
def test_plain_matches_interpret_and_fallback(n_bins):
    p, c = 2000, 7
    ids = RNG.integers(0, n_bins, p).astype(np.int32)
    data = RNG.normal(size=(p, c)).astype(np.float32)
    got = _np(B.bin_sum(t(data), t(ids), n_bins))
    interp = jbin(jnp.asarray(data), jnp.asarray(ids), n_bins,
                  interpret=True)
    fallback = jbin(jnp.asarray(data), jnp.asarray(ids), n_bins)
    np.testing.assert_allclose(got, _np(interp), **TOL)
    np.testing.assert_allclose(got, _np(fallback), **TOL)


def test_empty_and_single_bin_tiles():
    n_bins = 2 * BINS_PER_TILE
    ids = np.full(64, 5, np.int32)
    data = np.ones((64, 3), np.float32)
    got = _np(B.bin_sum(t(data), t(ids), n_bins))
    want = _np(jbin(jnp.asarray(data), jnp.asarray(ids), n_bins,
                    interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[5].tolist() == [64.0, 64.0, 64.0]
    assert np.abs(np.delete(got, 5, axis=0)).sum() == 0.0


def test_out_of_range_ids_clip():
    n_bins = 128
    ids = np.array([-5, 0, 127, 500], np.int32)
    data = np.ones((4, 2), np.float32)
    got = _np(B.bin_sum(t(data), t(ids), n_bins))
    want = _np(jbin(jnp.asarray(data), jnp.asarray(ids), n_bins,
                    interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 2.0 and got[127, 0] == 2.0


@pytest.mark.parametrize('transposed', [False, True])
def test_pillar_epilogue_bf16(transposed):
    """The fused pillar epilogue with bf16 output, compared after an fp32
    cast at bf16 resolution (8 mantissa bits: rtol 2^-7)."""
    p, c, nz = 3000, 5, 8
    n_bins = 2 * BINS_PER_TILE + 11
    pts = RNG.normal(size=(p, c)).astype(np.float32)
    ids = RNG.integers(0, n_bins // 3, p).astype(np.int32)
    zbin = RNG.integers(0, nz, p)
    data = np.concatenate([np.ones((p, 1), np.float32), pts,
                           pts[:, 2:3] ** 2, np.eye(nz, dtype=np.float32)[zbin]],
                          axis=1)
    got = B.bin_sum(t(data), t(ids), n_bins, pillar_features=c,
                    out_dtype=torch.bfloat16, transposed_out=transposed)
    assert got.dtype == torch.bfloat16
    want = jbin(jnp.asarray(data), jnp.asarray(ids), n_bins,
                finalize=jpe._pillar_finalize(c), out_dtype=jnp.bfloat16,
                transposed_out=transposed, interpret=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-2)


def test_presorted_and_unsorted_agree():
    """A tile-sorted input gives the same sums whether or not the caller
    says it is presorted, and the same as the shuffled input."""
    p, c, n_bins = 4000, 6, 5 * BINS_PER_TILE
    ids = np.sort(RNG.integers(0, n_bins, p)).astype(np.int32)
    data = RNG.normal(size=(p, c)).astype(np.float32)
    perm = RNG.permutation(p)
    a = B.bin_sum(t(data), t(ids), n_bins, presorted=True)
    b = B.bin_sum(t(data), t(ids), n_bins, presorted=False)
    s = B.bin_sum(t(data[perm]), t(ids[perm]), n_bins)
    np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(_np(a), _np(s), **TOL)


@pytest.mark.parametrize('layout', ['cf', 'bev'])
def test_pillarize_matches_jax(layout):
    """The port's pillarize vs JAX pillarize on make_batch-like clouds
    (tile-sorted, some points outside the grid, some masked)."""
    from streamingflow_tpu.data import make_batch, tiny_config
    cfg = tiny_config()
    se = cfg.MODEL.SPARSE_ENCODER
    pts = make_batch(cfg, 1, seed=3, n_points=1024)['points'][0, 0]
    mask = RNG.random(pts.shape[0]) > 0.05
    want = jpe.pillarize(jnp.asarray(pts), jnp.asarray(mask),
                         se.POINT_CLOUD_RANGE, se.VOXEL_SIZE,
                         out_dtype=jnp.bfloat16, presorted=True,
                         layout=layout)
    got = ppe.pillarize(t(pts), t(mask), se.POINT_CLOUD_RANGE,
                        se.VOXEL_SIZE, out_dtype=torch.bfloat16,
                        presorted=True, layout=layout)
    assert tuple(got.shape) == want.shape
    assert _np(got)[..., :].any()
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-2)


def test_wrapper_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    """A CPU tensor never reaches the kernel (the count stays put)."""
    monkeypatch.setattr(B, 'launches', 0)
    B.bin_sum(torch.ones(4, 3), torch.zeros(4, dtype=torch.int32), 10)
    assert B.launches == 0
