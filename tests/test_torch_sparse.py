"""The port's column engine (streamingflow_tpu_torch/ops/voxelize.py,
sparse_columns.py, winfuse.py) against the JAX package's on the CPU.

Integer outputs (ids, masks, neighbour maps, drop counts) must be equal;
fp32 values agree to 1e-6 (voxel means), 1e-5 (strided conv) and 2e-5 (the
submanifold conv, the bar of tests/test_winfuse.py).  K3's plain version is
held against the Pallas kernel itself in interpret mode.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from streamingflow_tpu.ops import pallas_winfuse as JWF
from streamingflow_tpu.ops import sparse_columns as JSC
from streamingflow_tpu.ops import voxelize as JV
from streamingflow_tpu_torch.ops import sparse_columns as SC
from streamingflow_tpu_torch.ops import voxelize as V
from streamingflow_tpu_torch.ops import winfuse as WF

from torch_parity import t

SHAPE = (16, 12, 9)


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _sites(seed, shape=SHAPE, n=300, column_heavy=False, cin=8):
    """Sorted unique site ids (x-major, z minor) with features, padded to
    512 rows; the four grid corners and edge midpoints are always active,
    so the windows of the maps reach the grid's edges."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    if column_heavy:
        cols = rng.integers(0, nx * ny, n // 4)
        ids = np.concatenate([c * nz + rng.choice(nz, rng.integers(1, 8),
                                                  replace=False)
                              for c in cols])
    else:
        ids = rng.choice(nx * ny * nz, n, replace=False)
    edge = [(0, 0), (0, ny - 1), (nx - 1, 0), (nx - 1, ny - 1),
            (nx // 2, 0), (0, ny // 2), (nx - 1, ny // 2)]
    ids = np.unique(np.concatenate(
        [ids, [(x * ny + y) * nz + nz // 2 for x, y in edge]]))[:512]
    cap = 512
    idp = np.full(cap, JV.LARGE_ID, np.int64)
    idp[:len(ids)] = ids
    mask = np.arange(cap) < len(ids)
    feats = rng.normal(size=(cap, cin)).astype(np.float32)
    feats[~mask] = 0
    return feats, idp.astype(np.int32), mask


def _columns(seed, cap_cols, **kw):
    feats, ids, mask = _sites(seed, **kw)
    jcs = JSC.from_sites(jnp.asarray(feats), jnp.asarray(ids),
                         jnp.asarray(mask), SHAPE, cap_cols)
    pcs = SC.from_sites(t(feats), t(ids), t(mask), SHAPE, cap_cols)
    return jcs, pcs


@pytest.mark.parametrize('max_points,max_voxels', [(10, 4096), (3, 200)])
def test_voxelize_matches_jax(max_points, max_voxels):
    """Stable sort, first points of each voxel, lowest ids over the cap;
    points out of range and zero padding rows dropped."""
    rng = np.random.default_rng(1)
    pc_range = [-4.0, -4.0, -4.0, 4.0, 4.0, 3.68]
    vsize = [0.25, 0.25, 0.32]
    pts = np.concatenate([rng.uniform(-4.4, 4.4, (1500, 5)),
                          rng.uniform(-0.6, 0.6, (400, 5)),
                          np.zeros((100, 5))]).astype(np.float32)
    pts[:, 2] = np.clip(pts[:, 2], -4.3, 3.9)
    pmask = (pts[:, :3] != 0).any(-1)
    want = JV.voxelize(jnp.asarray(pts), jnp.asarray(pmask), pc_range, vsize,
                       max_points, max_voxels)
    got = V.voxelize(t(pts), t(pmask), pc_range, vsize, max_points,
                     max_voxels)
    if max_voxels == 200:
        assert bool(want.mask.all())        # the cap binds
    _eq(got.ids, want.ids, 'ids')
    _eq(got.mask, want.mask, 'mask')
    _eq(got.coords, want.coords, 'coords')
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('column_heavy', [False, True])
@pytest.mark.parametrize('cap_cols', [256, 48])
def test_column_set_and_map_match_jax(column_heavy, cap_cols):
    """from_sites (cap 48 drops the highest columns) and build_column_map,
    edge columns included, equal the JAX package's."""
    jcs, pcs = _columns(3, cap_cols, column_heavy=column_heavy)
    for name in jcs._fields:
        _eq(getattr(pcs, name), getattr(jcs, name), name)
    jm = JSC.build_column_map(jcs, SHAPE[:2])
    pm = SC.build_column_map(pcs, SHAPE[:2])
    _eq(pm.found, jm.found, 'found')
    _eq(pm.nbr, jm.nbr, 'nbr')
    assert int(pm.found[0].sum()) > 0


@pytest.mark.parametrize('kernel,stride,padding', [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),      # down1, down2
    ((3, 3, 3), (2, 2, 2), (1, 1, 0)),      # down3
    ((1, 1, 3), (1, 1, 2), (0, 0, 0)),      # conv_out (scalar lookups)
])
def test_strided_conv_matches_jax(kernel, stride, padding):
    jcs, pcs = _columns(4, 256, column_heavy=True)
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(int(np.prod(kernel)), 8, 12)) * 0.3).astype(
        np.float32)
    out_grid = tuple((SHAPE[d] + 2 * padding[d] - kernel[d]) // stride[d] + 1
                     for d in range(2))
    cap = min(160, out_grid[0] * out_grid[1])
    want, wshape = JSC.sparse_conv_columns(jcs, jnp.asarray(w), kernel,
                                           stride, padding, SHAPE, cap,
                                           mask_output=False)
    got, gshape = SC.sparse_conv_columns(pcs, t(w), kernel, stride, padding,
                                         SHAPE, cap)
    assert gshape == wshape
    for name in ('col_ids', 'col_coords', 'col_mask', 'zmask'):
        _eq(getattr(got, name), getattr(want, name), name)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('column_heavy', [False, True])
@pytest.mark.parametrize('block,window,resid', [
    (16, 64, 4),    # wide window: nothing overflows
    (16, 32, 64),   # overflowing blocks all on the residual path
    (16, 20, 1),    # tight window, one residual block: taps dropped
])
def test_plain_subm_matches_pallas_interpret(column_heavy, block, window,
                                             resid):
    """K3's plain version with the plan's effective found mask vs the
    Pallas kernel in interpret mode: same values, same drop count."""
    jcs, pcs = _columns(11, 256, column_heavy=column_heavy)
    rng = np.random.default_rng(12)
    w = (rng.normal(size=(27, 8, 12)) * 0.3).astype(np.float32)
    jm = JSC.build_column_map(jcs, SHAPE[:2])
    plan = JWF.build_fused_plan(jm, jcs.col_mask, block=block, window=window,
                                resid_blocks=resid)
    want = JWF.subm_conv_winfuse(jcs.feats, jcs.zmask, jm, plan,
                                 jnp.asarray(w), mask_output=False,
                                 window=window, interpret=True)
    found, n_dropped = WF.fused_found(SC.build_column_map(pcs, SHAPE[:2]),
                                      block, window, resid)
    assert int(n_dropped) == int(plan.n_dropped)
    if resid == 1:
        assert int(n_dropped) > 0
    nbr = SC.build_column_map(pcs, SHAPE[:2]).nbr
    got = WF.subm_conv_winfuse(pcs.feats, nbr, found, t(w), SHAPE[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_subm_matches_sep_and_stacked_clouds():
    """Without drops the conv is the JAX 'sep' formulation; two clouds
    stacked into one call (slots offset by the cloud's first row) give each
    cloud's own result."""
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(27, 8, 12)) * 0.3).astype(np.float32)
    outs, feats, nbrs, founds = [], [], [], []
    for i, seed in enumerate((21, 22)):
        jcs, pcs = _columns(seed, 256, column_heavy=True)
        jm = JSC.build_column_map(jcs, SHAPE[:2])
        outs.append(np.asarray(JSC.subm_conv_columns(
            jcs.feats, jcs.zmask, jm, jnp.asarray(w), formulation='sep',
            mask_output=False)))
        pm = SC.build_column_map(pcs, SHAPE[:2])
        feats.append(pcs.feats)
        nbrs.append(pm.nbr + i * 256)
        founds.append(pm.found)
    launches = WF.launches
    got = WF.subm_conv_winfuse(torch.cat(feats), torch.cat(nbrs, 1),
                               torch.cat(founds, 1), t(w), SHAPE[2])
    assert WF.launches == launches          # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), np.concatenate(outs), rtol=2e-5,
                               atol=2e-5)


def test_columns_to_dense_matches_jax():
    jcs, pcs = _columns(6, 256)
    want = JSC.columns_to_dense(jcs, SHAPE, 8)
    got = SC.columns_to_dense(pcs, SHAPE, 8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _eq(got[1], want[1], 'occupancy')
