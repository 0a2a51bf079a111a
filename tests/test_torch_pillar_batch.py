"""The port's one-launch pillar statistics (pillarize_batch, bin_sum_clouds)
and the bin-sum wrapper's index arithmetic.

pillarize_batch of the port (on the CPU: the plain version) is held against
the JAX package's pillarize_batch (its XLA fallback on the CPU) and against
the port's per-cloud pillarize, in fp32 at rtol 1e-5 / atol 1e-4 (the JAX
package's bin-sum bar, tests/test_pallas_bin.py), on a grid whose last tile
is ragged, with a cloud entirely outside the grid and an empty one, tile
sorted and unsorted.

The kernel's tile bounds and padded rows are computed in Python; they are
held against numpy, and the wrapper's path up to the launch is driven on
the CPU with the launch replaced by a numpy model of the kernel (one block
per 512-bin sub-tile of a 2048-bin tile, ids clipped in the block, bins
past ``n_store`` never written), against the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.models import pillar_encoder as jpe
from streamingflow_tpu_torch.native import tile_sort_points
from streamingflow_tpu_torch.models import pillar_encoder as ppe
from streamingflow_tpu_torch.ops import bin_sum as B

from torch_parity import t

TOL = dict(rtol=1e-5, atol=1e-4)
# nx = 100, ny = 60: 6001 bins, the last of 3 tiles holds 1905
PCR = (-5.0, -3.0, -2.0, 5.0, 3.0, 2.0)
VOXEL = (0.1, 0.1, 0.2)
SUB_BINS = 512


def _clouds(seed):
    """3 clouds of 600 points (x, y, z, intensity, time): cloud 0 mostly in
    the grid with a few outside, cloud 1 entirely outside, cloud 2 empty
    (all rows zero: masked).  Each tile-sorted as the loader sorts it."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((3, 600, 5), np.float32)
    pts[0, :, 0] = rng.uniform(-6, 6, 600)
    pts[0, :, 1] = rng.uniform(-3.5, 3.5, 600)
    pts[0, :, 2] = rng.uniform(-2.5, 2.5, 600)
    pts[0, :, 3:] = rng.uniform(0, 1, (600, 2))
    pts[1, :, 0] = rng.uniform(6, 9, 600)
    pts[1, :, 1:] = rng.uniform(-1, 1, (600, 4))
    for cloud in pts[:2]:
        tile_sort_points(cloud, 600, PCR, VOXEL, B.BINS_PER_TILE)
    return pts


@pytest.mark.parametrize('presorted', [True, False])
def test_pillarize_batch_matches_jax_and_per_cloud(presorted):
    pts = _clouds(0)
    if not presorted:
        pts = pts[:, np.random.default_rng(1).permutation(600)]
    mask = (pts[..., :3] != 0).any(-1)
    got = ppe.pillarize_batch(t(pts), t(mask), PCR, VOXEL,
                              presorted=presorted)
    want = jpe.pillarize_batch(jnp.asarray(pts), jnp.asarray(mask), PCR,
                               VOXEL, presorted=presorted)
    loop = torch.stack([ppe.pillarize(t(pts[i]), t(mask[i]), PCR, VOXEL,
                                      presorted=presorted, layout='cf')
                        for i in range(3)])
    assert tuple(got.shape) == want.shape == (3, 15, 100, 60)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, loop.numpy(), **TOL)
    assert got[0, 0].any() and not got[1:].any()


@pytest.mark.parametrize('n_bins', [100, 2048, 6001, 3 * 2048 + 7])
def test_tile_bounds_match_numpy(n_bins):
    """First row of each tile after the first, of ids grouped by tile of
    the clipped id (unsorted inside a tile, some out of range)."""
    rng = np.random.default_rng(n_bins)
    ids = rng.integers(-50, n_bins + 50, 3000).astype(np.int32)
    tiles = np.clip(ids, 0, n_bins - 1) // B.BINS_PER_TILE
    ids = ids[np.argsort(tiles, kind='stable')]
    tiles = np.sort(tiles)
    n_tiles = -(-n_bins // B.BINS_PER_TILE)
    want = np.searchsorted(tiles, np.arange(1, n_tiles), side='left')
    got = B.tile_bounds(t(ids), n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_padded_bins_match_numpy():
    n = np.arange(1, 100)
    assert [B.padded_bins(int(v)) for v in n] == \
        (np.ceil(n / 8) * 8).astype(int).tolist()
    assert B.padded_bins(1600 * 1600) == 1600 * 1600


def _kernel_model(data, ids, bounds, out, n_bins, bins_per_cloud, n_store,
                  pillar_features=None, k_tiles=None):
    """numpy model of csrc/bin_sum.cu on the launch's arguments."""
    assert data.is_contiguous() and ids.dtype == torch.int32
    assert out.stride(2) == 1 and out.stride(1) % 8 == 0
    data, ids, bounds = data.numpy(), ids.numpy(), bounds.numpy()
    o = out.view(-1)
    n_tiles = -(-n_bins // B.BINS_PER_TILE)
    edges = np.concatenate([[0], bounds, [len(ids)]])
    for tile in range(n_tiles):
        rows = slice(edges[tile], edges[tile + 1])
        local = np.clip(ids[rows], 0, n_bins - 1)
        for base in range(tile * B.BINS_PER_TILE,
                          (tile + 1) * B.BINS_PER_TILE, SUB_BINS):
            cloud, j0 = divmod(base, bins_per_cloud)
            if base >= n_bins or j0 >= n_store:
                continue
            acc = np.zeros((SUB_BINS, data.shape[1]), np.float32)
            hit = (local >= base) & (local < base + SUB_BINS)
            np.add.at(acc, local[hit] - base, data[rows][hit])
            vals = torch.from_numpy(acc).t()
            if pillar_features is not None:
                vals = B.pillar_finalize(vals, pillar_features)
            width = min(SUB_BINS, n_store - j0)
            for c in range(data.shape[1]):
                at = cloud * out.stride(0) + c * out.stride(1) + j0
                o[at:at + width] = vals[c, :width].to(out.dtype)


@pytest.mark.parametrize('clouds', [1, 3])
@pytest.mark.parametrize('presorted', [True, False])
@pytest.mark.parametrize('pillar', [False, True])
def test_wrapper_layout_with_a_model_of_the_kernel(monkeypatch, clouds,
                                                   presorted, pillar):
    """The wrapper's sort, bounds, padded rows and returned view, with the
    launch replaced by the numpy model of the kernel, equal the plain
    version: one cloud of 6001 bins (odd rows, padded to 6008), or three
    clouds of 3 tiles each storing 6000 bins (the trash bin unstored)."""
    monkeypatch.setattr(B, 'launch', _kernel_model)
    rng = np.random.default_rng(clouds * 4 + presorted * 2 + pillar)
    per_cloud = 6001 if clouds == 1 else 3 * B.BINS_PER_TILE
    n_store = 6001 if clouds == 1 else 6000
    p = 2500
    ids = rng.integers(-20, clouds * per_cloud + 20, p).astype(np.int32)
    ids[::5] = per_cloud - 1                 # a hot bin in the last tile
    data = rng.normal(size=(p, 15)).astype(np.float32)
    data[:, 0] = rng.integers(0, 3, p)       # counts, some 0
    if presorted:
        order = np.argsort(np.clip(ids, 0, clouds * per_cloud - 1)
                           // B.BINS_PER_TILE, kind='stable')
        ids, data = ids[order], data[order]
    kw = dict(pillar_features=5 if pillar else None,
              out_dtype=torch.float32)
    got = B._bin_sum_cuda(t(data), t(ids), clouds, per_cloud, n_store,
                          presorted=presorted, k_tiles=None, **kw)
    want = B.bin_sum_clouds_plain(t(data), t(ids), clouds, per_cloud,
                                  n_store, **kw)
    assert tuple(got.shape) == (clouds, 15, n_store)
    assert got.stride() == (15 * B.padded_bins(n_store),
                            B.padded_bins(n_store), 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    if clouds == 1:       # bin_sum's own views of the same storage
        single = B.bin_sum_plain(t(data), t(ids), 6001, **kw)
        np.testing.assert_allclose(got[0].t().numpy(), single.numpy(), **TOL)


def test_clouds_wrapper_checks_and_cpu_path(monkeypatch):
    """bin_sum_clouds takes its plain version for CPU tensors (no launch),
    refuses clouds whose bins straddle a tile, and launch refuses CPU
    tensors."""
    monkeypatch.setattr(B, 'launches', 0)
    data = torch.ones(4, 3)
    ids = torch.tensor([0, 5, 2048, 4100], dtype=torch.int32)
    out = B.bin_sum_clouds(data, ids, 2, 2048, 10)
    assert B.launches == 0 and tuple(out.shape) == (2, 3, 10)
    assert out[0, :, 0].tolist() == [1.0] * 3 and out[1, 0, 0] == 1.0
    assert out.sum() == 9.0                  # id 4100 clips to bin 4095
    with pytest.raises(ValueError, match='multiple of 2048'):
        B.bin_sum_clouds(data, ids, 2, 2000, 10)
    with pytest.raises(ValueError, match='n_store'):
        B.bin_sum_clouds(data, ids, 1, 2048, 0)
    with pytest.raises(ValueError, match='CUDA'):
        B.launch(data, ids, torch.zeros(0, dtype=torch.int32),
                 torch.empty(1, 3, 8), 8, 8, 8)
