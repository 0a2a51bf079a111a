"""Port's bin-sum (streamingflow_tpu_torch/ops/bin_sum.py) vs the JAX one.

On the CPU the wrapper takes its plain PyTorch version, which is held here
against streamingflow_tpu's Pallas kernel in interpret mode and against its
XLA segment-sum fallback, at the JAX package's own bin-sum tolerance
(rtol 1e-5 / atol 1e-4, tests/test_pallas_bin.py).  The CUDA kernel is
held against this plain version on the card by chip_smoke.py.

``bin_sum_grouped`` (the port of tools/exp_bin_variants.py's grouped-tile
variant) is held against that tool's own ``bin_sum_grouped``, run in
interpret mode by handing its ``pl.pallas_call`` the ``interpret=True``
argument from here; the tool's file is not edited.
"""
import functools
import importlib.util
from pathlib import Path

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


@pytest.fixture(scope='module')
def jax_grouped():
    """tools/exp_bin_variants.py::bin_sum_grouped with its Pallas kernel in
    interpret mode."""
    path = Path(__file__).resolve().parent.parent / 'tools' / \
        'exp_bin_variants.py'
    spec = importlib.util.spec_from_file_location('exp_bin_variants_jax',
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    real = tool.pl.pallas_call

    def grouped(*args, **kw):
        tool.pl.pallas_call = functools.partial(real, interpret=True)
        try:
            return tool.bin_sum_grouped(*args, **kw)
        finally:
            tool.pl.pallas_call = real
    return grouped


@pytest.mark.parametrize('k_tiles', [1, 4, 8])
def test_grouped_matches_the_tools_grouped_kernel(jax_grouped, k_tiles):
    """Raw sums over 5 tiles (no multiple of 4 or 8: the last group is
    ragged), one of them empty, ids out of range clipped."""
    p, c = 3000, 6
    n_bins = 4 * BINS_PER_TILE + 9
    ids = RNG.integers(-3, n_bins + 3, p).astype(np.int32)
    ids[(ids >= BINS_PER_TILE) & (ids < 2 * BINS_PER_TILE)] = 5
    data = RNG.normal(size=(p, c)).astype(np.float32)
    got = _np(B.bin_sum_grouped(t(data), t(ids), n_bins, k_tiles=k_tiles))
    want = jax_grouped(jnp.asarray(data), jnp.asarray(ids), n_bins,
                       k_tiles=k_tiles)
    assert got.shape == want.shape == (n_bins, c)
    assert not got[BINS_PER_TILE:2 * BINS_PER_TILE].any()
    np.testing.assert_allclose(got, _np(want), **TOL)
    np.testing.assert_allclose(got, _np(B.bin_sum(t(data), t(ids), n_bins)),
                               **TOL)


@pytest.mark.parametrize('k_tiles', [1, 4])
def test_grouped_pillar_epilogue_bf16(jax_grouped, k_tiles):
    p, c, nz = 3000, 5, 8
    n_bins = 2 * BINS_PER_TILE + 11
    pts = RNG.normal(size=(p, c)).astype(np.float32)
    ids = np.sort(RNG.integers(0, n_bins // 3, p)).astype(np.int32)
    zbin = RNG.integers(0, nz, p)
    data = np.concatenate([np.ones((p, 1), np.float32), pts,
                           pts[:, 2:3] ** 2, np.eye(nz, dtype=np.float32)[zbin]],
                          axis=1)
    got = B.bin_sum_grouped(t(data), t(ids), n_bins, pillar_features=c,
                            out_dtype=torch.bfloat16, presorted=True,
                            k_tiles=k_tiles)
    want = jax_grouped(jnp.asarray(data), jnp.asarray(ids), n_bins,
                       finalize=jpe._pillar_finalize(c),
                       out_dtype=jnp.bfloat16, presorted=True,
                       k_tiles=k_tiles)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-2)


def test_grouped_wrapper_takes_plain_version_only_for_cpu_tensors(
        monkeypatch):
    monkeypatch.setattr(B, 'launches_grouped', 0)
    B.bin_sum_grouped(torch.ones(4, 3), torch.zeros(4, dtype=torch.int32),
                      10)
    assert B.launches_grouped == 0
    with pytest.raises(ValueError, match='k_tiles'):
        B.bin_sum_grouped(torch.ones(4, 3),
                          torch.zeros(4, dtype=torch.int32), 10, k_tiles=0)


def test_tool_rows_and_cpu_check():
    """The port's experiment tool builds sorted pillar rows like the JAX
    tool's and, on the CPU, checks every k_tiles without timing."""
    from streamingflow_tpu_torch.tools import exp_bin_variants as tool
    datas, ids, n_bins = tool.bench_rows(n_clouds=2, n_points=500)
    assert datas.shape == (2, 500, 15) and ids.shape == (2, 500)
    assert n_bins == 1600 * 1600 + 1 and (np.diff(ids, axis=1) >= 0).all()
    assert (datas[..., 0] == (ids < n_bins - 1)).all()
    out = tool.run((1, 4), device='cpu', n_clouds=1, n_points=500)
    assert set(out['max_abs_diff_vs_plain']) == {'1', '4'}
    assert 'grouped_ms_5_clouds' not in out
