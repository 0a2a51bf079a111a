"""The port's site engines and column options (streamingflow_tpu_torch/ops/
sparse.py, sparse_tiled.py, sparse_columns.py, winfuse.py::window_found)
against the JAX package's ops on the CPU.

Integer outputs (neighbour maps, output sites, slots, tiles, kept taps,
drop counts) must be equal; fp32 values and their gradients (against
``jax.vjp``) within 1e-5 of their scale.  The site convs are held both
through the single-cloud wrappers (``gather_gemm``, ``subm_conv3d``,
``sparse_conv3d``) and through the route the encoder runs (two clouds'
maps into one ``stacked_src``, one ``gather_product``).  The tiled
engine's function is held at op level: the port runs the gather engine's
sums over the sites of the kept tiles (ops/sparse_tiled.py), the JAX
package its dense tile convs.  The dense-grid entries are held at the
channel and z widths of stages 3 (64 channels, nz 11) and 4 (128, nz 5)
on a small (x, y) grid.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from streamingflow_tpu.ops import sparse as JS
from streamingflow_tpu.ops import sparse_columns as JSC
from streamingflow_tpu.ops import sparse_tiled as JST
from streamingflow_tpu_torch.ops import sparse as S
from streamingflow_tpu_torch.ops import sparse_columns as SC
from streamingflow_tpu_torch.ops import sparse_tiled as ST
from streamingflow_tpu_torch.ops import winfuse as WF

from test_sparse_tiled import _make_set
from torch_parity import assert_close, t

SHAPE = (32, 24, 16)
STRIDED = {'down1': ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
           'down3': ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
           'conv_out': ((1, 1, 3), (1, 1, 2), (0, 0, 0))}


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _sites(seed=13, shape=SHAPE, n=600, cap=1024, cluster=True):
    jst = _make_set(np.random.default_rng(seed), shape, n, cap,
                    cluster=cluster)
    pst = S.SparseTensor(t(jst.feats), t(jst.coords), t(jst.ids),
                         t(jst.mask), shape)
    return jst, pst


def _weights(seed, k, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, cin, cout)) * (k * cin) ** -0.5).astype(
        np.float32)


def _vjp(fn, *args, cot):
    with jax.default_matmul_precision('highest'):
        out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
        return np.asarray(out), [np.asarray(g) for g in vjp(
            jnp.asarray(cot))]


@pytest.mark.parametrize('cluster', [False, True])
def test_neighbor_map_matches_jax(cluster):
    jst, pst = _sites(cluster=cluster)
    want = JS.build_neighbor_map(jst, 3)
    got = S.build_neighbor_map(pst, 3)
    _eq(got.idx, want.idx, 'idx')
    _eq(got.found, want.found, 'found')
    assert 0 < int(want.found.sum()) < want.found.size


def test_gather_gemm_and_its_gradients_match_jax():
    jst, pst = _sites()
    nmap = JS.build_neighbor_map(jst, 3)
    w = _weights(1, 27, 8, 12)
    cot = np.random.default_rng(2).normal(size=(1024, 12)).astype(np.float32)
    want, (w_df, w_dw) = _vjp(
        lambda f, ww: JS.gather_gemm(f, nmap, ww, jst.mask), jst.feats, w,
        cot=cot)
    f = pst.feats.clone().requires_grad_()
    wt = t(w).requires_grad_()
    got = S.gather_gemm(f, S.NeighborMap(t(nmap.idx).long(), t(nmap.found)),
                        wt, pst.mask)
    got.backward(t(cot))
    assert_close(got, want, 1e-5, 'out')
    assert_close(f.grad, w_df, 1e-5, 'd feats')
    assert_close(wt.grad, w_dw, 1e-5, 'd weights')


@pytest.mark.parametrize('mode', ['sites', 'nmap', 'src'])
@pytest.mark.parametrize('conv', list(STRIDED))
def test_output_sites_match_jax(conv, mode):
    jst, pst = _sites()
    kernel, stride, padding = STRIDED[conv]
    out_shape = S.conv_out_shape(SHAPE, kernel, stride, padding)
    kw = {'nmap': dict(return_nmap=True), 'src': dict(return_src=True),
          'sites': {}}[mode]
    want = JS.generate_output_sites(jst, kernel, stride, padding, out_shape,
                                    1024, **kw)
    got = S.generate_output_sites(pst, kernel, stride, padding, out_shape,
                                  1024, **kw)
    sites = want if mode == 'sites' else want[0]
    for name, g, w in zip(('ids', 'coords', 'mask'), got[:3], sites):
        _eq(g, w, name)
    if mode == 'nmap':
        _eq(got.nmap.idx, want[1].idx, 'nmap idx')
        _eq(got.nmap.found, want[1].found, 'nmap found')
    if mode == 'src':
        _eq(got.src, want[1], 'src')
    assert int(sites[2].sum()) > 100


@pytest.mark.parametrize('mode', ['nmap', 'src'])
def test_output_sites_truncate_at_the_cap_as_jax(mode):
    """More output sites than slots: the lowest ids are kept, rank < cap,
    each run's head choosing the output's slot and source."""
    jst, pst = _sites()
    kernel, stride, padding = STRIDED['down1']
    out_shape = S.conv_out_shape(SHAPE, kernel, stride, padding)
    full = JS.generate_output_sites(jst, kernel, stride, padding, out_shape,
                                    4096)
    n_out = int(full[2].sum())
    cap = n_out // 3
    kw = dict(return_nmap=True) if mode == 'nmap' else dict(return_src=True)
    (ids, coords, mask), extra = JS.generate_output_sites(
        jst, kernel, stride, padding, out_shape, cap, **kw)
    got = S.generate_output_sites(pst, kernel, stride, padding, out_shape,
                                  cap, **kw)
    assert int(mask.sum()) == cap
    _eq(got.ids, ids, 'ids')
    _eq(got.coords, coords, 'coords')
    _eq(got.mask, mask, 'mask')
    _eq(got.ids, np.asarray(full[0])[:cap], 'the lowest ids')
    if mode == 'nmap':
        _eq(got.nmap.idx, extra.idx, 'nmap idx')
        _eq(got.nmap.found, extra.found, 'nmap found')
    else:
        _eq(got.src, extra, 'src')


@pytest.mark.parametrize('conv', list(STRIDED))
def test_sparse_conv3d_and_its_gradients_match_jax(conv):
    jst, pst = _sites()
    kernel, stride, padding = STRIDED[conv]
    w = _weights(3, int(np.prod(kernel)), 8, 12)
    want = JS.sparse_conv3d(jst, jnp.asarray(w), kernel, stride, padding,
                            1024)
    cot = np.random.default_rng(4).normal(size=(1024, 12)).astype(np.float32)
    _, (w_df, w_dw) = _vjp(
        lambda f, ww: JS.sparse_conv3d(jst._replace(feats=f), ww, kernel,
                                       stride, padding, 1024).feats,
        jst.feats, w, cot=cot)
    f = pst.feats.clone().requires_grad_()
    wt = t(w).requires_grad_()
    got = S.sparse_conv3d(pst._replace(feats=f), wt, kernel, stride,
                          padding, 1024)
    got.feats.backward(t(cot))
    assert got.shape == want.shape
    for name in ('ids', 'coords', 'mask'):
        _eq(getattr(got, name), getattr(want, name), name)
    assert_close(got.feats, want.feats, 1e-5, 'feats')
    assert_close(f.grad, w_df, 1e-5, 'd feats')
    assert_close(wt.grad, w_dw, 1e-5, 'd weights')


@pytest.mark.parametrize('conv', ['subm'] + list(STRIDED))
def test_stacked_site_convs_match_jax(conv):
    """The encoder's route for its site convs: two clouds' maps into one
    src (``stacked_src``) and one ``gather_product`` over their stacked
    rows, against the JAX package's subm_conv3d / sparse_conv3d of each
    cloud, with gradients (d weights: the sum over the clouds)."""
    clouds = [_sites(seed=seed) for seed in (13, 17)]
    v_in = clouds[0][1].ids.shape[0]
    if conv == 'subm':
        kernel = (3, 3, 3)
        maps = [S.build_neighbor_map(pst) for _, pst in clouds]
    else:
        kernel, stride, padding = STRIDED[conv]
        out_shape = S.conv_out_shape(SHAPE, kernel, stride, padding)
        maps = [S.generate_output_sites(pst, kernel, stride, padding,
                                        out_shape, 1024,
                                        return_nmap=True).nmap
                for _, pst in clouds]
    w = _weights(6, int(np.prod(kernel)), 8, 12)
    rng = np.random.default_rng(7)
    cots = [rng.normal(size=(1024, 12)).astype(np.float32) for _ in clouds]

    def jax_conv(jst):
        def fn(f, ww):
            st = jst._replace(feats=f)
            if conv == 'subm':
                return JS.subm_conv3d(st, ww).feats
            return JS.sparse_conv3d(st, ww, kernel, stride, padding,
                                    1024).feats
        return fn

    wants = [_vjp(jax_conv(jst), jst.feats, w, cot=cot)
             for (jst, _), cot in zip(clouds, cots)]
    f = torch.cat([pst.feats for _, pst in clouds]).requires_grad_()
    wt = t(w).requires_grad_()
    got = S.gather_product(f, S.stacked_src(maps, v_in), wt)
    got.backward(t(np.concatenate(cots)))
    for i, (want, (w_df, _)) in enumerate(wants):
        rows = slice(i * v_in, (i + 1) * v_in)
        assert_close(got[i * 1024:(i + 1) * 1024], want, 1e-5, f'out {i}')
        assert_close(f.grad[rows], w_df, 1e-5, f'd feats {i}')
    assert_close(wt.grad, sum(g[1] for _, g in wants), 1e-5, 'd weights')


def test_subm_conv3d_and_to_dense_match_jax():
    jst, pst = _sites(cluster=False)
    w = _weights(5, 27, 8, 12)
    with jax.default_matmul_precision('highest'):
        want = JS.subm_conv3d(jst, jnp.asarray(w))
        dense = JS.to_dense(want)
    got = S.subm_conv3d(pst, t(w))
    assert_close(got.feats, want.feats, 1e-5, 'subm')
    assert_close(S.to_dense(got), dense, 1e-5, 'to_dense')


@pytest.mark.parametrize('cap_tiles', ['sized', 'overflow'])
@pytest.mark.parametrize('tile', [(8, 8, 8), (8, 8, 4)])
def test_tile_map_matches_jax(tile, cap_tiles):
    jst, pst = _sites()
    full = JST.build_tile_map(jst.coords, jst.ids, jst.mask, SHAPE, 512,
                              tile=tile)
    n_tiles = int(full.tile_mask.sum())
    cap = 512 if cap_tiles == 'sized' else n_tiles - 3
    want = JST.build_tile_map(jst.coords, jst.ids, jst.mask, SHAPE, cap,
                              tile=tile)
    got = ST.build_tile_map(pst.coords, pst.ids, pst.mask, SHAPE, cap,
                            tile=tile)
    for name in ('tile_ids', 'tile_mask', 'site_flat', 'occupancy'):
        _eq(getattr(got, name), getattr(want, name), name)
    dropped = int(ST.dropped_sites(got, pst.mask))
    assert dropped == int(JST.dropped_sites(want, jst.mask))
    assert (dropped > 0) == (cap_tiles == 'overflow')
    assert int((pst.mask & ~got.kept).sum()) == dropped


def test_tile_cap_overflow_drops_the_highest_tiles():
    """The case of tests/test_sparse_tiled.py's overflow test: one tile
    slot too few drops the sites of the highest tile id, which read back
    zero; the kept sites equal the JAX tiled conv's."""
    rng = np.random.default_rng(5)
    shape = (32, 8, 8)
    jst = _make_set(rng, shape, 100, 128)
    pst = S.SparseTensor(t(jst.feats), t(jst.coords), t(jst.ids),
                         t(jst.mask), shape)
    w = _weights(6, 27, 8, 8)
    full = JST.build_tile_map(jst.coords, jst.ids, jst.mask, shape, 32)
    small = JST.build_tile_map(jst.coords, jst.ids, jst.mask, shape,
                               int(full.tile_mask.sum()) - 1)
    with jax.default_matmul_precision('highest'):
        want = JST.subm_conv3d_tiled(jst.feats, jst.mask, small,
                                     jnp.asarray(w))
    tmap = ST.build_tile_map(pst.coords, pst.ids, pst.mask, shape,
                             int(full.tile_mask.sum()) - 1)
    kept = tmap.kept
    got = _tiled_subm(pst, kept, t(w))
    dropped = (pst.mask & ~kept).numpy()
    assert dropped.sum() > 0
    assert float(got[torch.from_numpy(dropped)].abs().max()) == 0
    assert_close(got[kept], np.asarray(want)[kept.numpy()], 1e-5, 'kept')


def _tiled_subm(pst, kept, w):
    """The tiled engine's submanifold conv on the gather engine: the kept
    tiles' sites alone, zero elsewhere."""
    nmap = S.build_neighbor_map(pst, 3)
    f = torch.where(kept[:, None], pst.feats, 0)
    return S.gather_gemm(f, nmap, w, kept)


def _tiled_strided(pst, kept, w, conv, cap):
    """The tiled engine's strided conv on the gather engine: output sites
    from every input site; the kept inputs' sums; zero where the least
    contributing input's tile was dropped."""
    kernel, stride, padding = conv
    out_shape = S.conv_out_shape(pst.shape, *conv)
    sites = S.generate_output_sites(pst, kernel, stride, padding, out_shape,
                                    cap, return_nmap=True, return_src=True)
    f = torch.where(kept[:, None], pst.feats, 0)
    out = S.gather_gemm(f, sites.nmap, w, sites.mask)
    return torch.where((kept[sites.src] & sites.mask)[:, None], out, 0), \
        sites


@pytest.mark.parametrize('conv', list(STRIDED))
def test_tiled_strided_conv_and_gradients_match_jax_under_overflow(conv):
    """A strided conv over resident tiles with the tile cap overflowing:
    the port's rule on the gather engine against the JAX tile conv
    (``sparse_conv_tiles``), values and ``jax.vjp`` in the features and
    weights."""
    jst, pst = _sites()
    kernel, stride, padding = STRIDED[conv]
    full = JST.build_tile_map(jst.coords, jst.ids, jst.mask, SHAPE, 512)
    cap_t = int(full.tile_mask.sum()) - 4
    jt = JST.build_tile_map(jst.coords, jst.ids, jst.mask, SHAPE, cap_t)
    out_shape = S.conv_out_shape(SHAPE, kernel, stride, padding)
    (oi, oc, om), src = JS.generate_output_sites(
        jst, kernel, stride, padding, out_shape, 2048, return_src=True)
    w = _weights(7, int(np.prod(kernel)), 8, 12)

    def jax_fn(f, ww):
        tiles = JST.to_tiles(f, jt, jst.mask)
        return JST.sparse_conv_tiles(tiles, jt, jst.coords, ww, kernel,
                                     stride, padding, oc, om, src)
    cot = np.random.default_rng(8).normal(size=(2048, 12)).astype(np.float32)
    want, (w_df, w_dw) = _vjp(jax_fn, jst.feats, w, cot=cot)

    kept = ST.build_tile_map(pst.coords, pst.ids, pst.mask, SHAPE,
                             cap_t).kept
    f = pst.feats.clone().requires_grad_()
    wt = t(w).requires_grad_()
    got, sites = _tiled_strided(pst._replace(feats=f), kept, wt,
                                STRIDED[conv], 2048)
    got.backward(t(cot))
    _eq(sites.mask, om, 'output sites')
    zeroed = (sites.mask & ~kept[sites.src]).numpy()
    assert zeroed.sum() > 0
    assert_close(got, want, 1e-5, 'out')
    assert_close(f.grad, w_df, 1e-5, 'd feats')
    assert_close(wt.grad, w_dw, 1e-5, 'd weights')


def test_tiled_subm_gradients_match_jax_under_overflow():
    jst, pst = _sites(cluster=False)
    full = JST.build_tile_map(jst.coords, jst.ids, jst.mask, SHAPE, 512)
    cap_t = int(full.tile_mask.sum()) - 4
    jt = JST.build_tile_map(jst.coords, jst.ids, jst.mask, SHAPE, cap_t)
    kept = ST.build_tile_map(pst.coords, pst.ids, pst.mask, SHAPE,
                             cap_t).kept
    w = _weights(9, 27, 8, 12)
    # the JAX conv reads back only at the kept sites (a dropped site's
    # from_tiles row is not the engine's value: the encoder never reads it)
    km = jnp.asarray(kept.numpy())
    cot = np.random.default_rng(10).normal(size=(1024, 12)).astype(np.float32)
    want, (w_df, w_dw) = _vjp(
        lambda f, ww: jnp.where(km[:, None], JST.subm_conv3d_tiled(
            f, jst.mask, jt, ww), 0), jst.feats, w, cot=cot)
    f = pst.feats.clone().requires_grad_()
    wt = t(w).requires_grad_()
    got = _tiled_subm(pst._replace(feats=f), kept, wt)
    got.backward(t(cot))
    assert int((pst.mask & ~kept).sum()) > 0
    assert_close(got, want, 1e-5, 'out')
    assert_close(f.grad, w_df, 1e-5, 'd feats')
    assert_close(wt.grad, w_dw, 1e-5, 'd weights')


def _win_case(block, window, resid):
    from test_sparse_columns import _make_set as column_set
    rng = np.random.default_rng(3)
    shape = (16, 12, 9)
    jst = column_set(rng, shape, 300, 512)
    cs = JSC.from_sites(jst.feats, jst.ids, jst.mask, shape, 256)
    cmap = JSC.build_column_map(cs, shape[:2])
    plan = JSC.build_window_plan(cmap, cs.col_mask, block=block,
                                 window=window, resid_blocks=resid)
    # the taps the JAX 'win' conv takes: dx = 0 always; a side tap through
    # its window (rel >= 0) or its block's residual gather (rfound)
    found = np.asarray(cmap.found).copy()
    rel = np.asarray(plan.rel)[:, :256]
    rows = np.asarray(plan.rrows)[np.asarray(plan.rmask)]
    for i, k in enumerate((0, 1, 2, 6, 7, 8)):
        resid_k = np.zeros(256, bool)
        resid_k[rows] = np.asarray(plan.rfound)[i][np.asarray(plan.rmask)]
        found[k] = (rel[i] >= 0) | resid_k
    got, dropped = WF.window_found(
        SC.ColumnMap(t(cmap.nbr), t(cmap.found)), block, window, resid)
    return got, dropped, found, int(plan.n_dropped)


@pytest.mark.parametrize('block,window,resid,drops', [
    (16, 4, 1, True),      # tests/test_sparse_columns.py's overflow case
    (16, 8, 2, True),
    (32, 48, 8, False),
    (16, 64, 16, False)])
def test_window_found_matches_the_window_plan(block, window, resid, drops):
    got, dropped, want, want_dropped = _win_case(block, window, resid)
    _eq(got, want, 'kept taps')
    assert int(dropped) == want_dropped
    assert (want_dropped > 0) == drops


@pytest.mark.parametrize('stage,nz,c', [(3, 11, 64), (4, 5, 128)])
def test_dense_entries_match_jax_at_stage_widths(stage, nz, c):
    """columns_to_dense and to_dense_bev at stage 3's and stage 4's channel
    and z widths on a 10 x 9 grid (a fifth of the slots empty)."""
    rng = np.random.default_rng(stage)
    nx, ny, cap = 10, 9, 64
    ids = np.sort(rng.choice(nx * ny, 51, replace=False))
    col_ids = np.concatenate([ids, np.full(cap - 51, 2 ** 31 - 1)])
    col_mask = np.arange(cap) < 51
    coords = np.stack([np.where(col_mask, col_ids // ny, 0),
                       np.where(col_mask, col_ids % ny, 0)], -1)
    zmask = (rng.random((cap, nz)) < 0.4) & col_mask[:, None]
    feats = rng.normal(size=(cap, nz * c)).astype(np.float32)
    jcs = JSC.ColumnSet(*(jnp.asarray(a) for a in (
        feats, col_ids.astype(np.int32), coords.astype(np.int32), col_mask,
        zmask)))
    pcs = SC.ColumnSet(*(t(np.asarray(a)) for a in jcs))
    want_x, want_m = JSC.columns_to_dense(jcs, (nx, ny, nz), c)
    got_x, got_m = SC.columns_to_dense(pcs, (nx, ny, nz), c)
    _eq(got_m, want_m, 'occupancy')
    assert_close(got_x, want_x, 1e-6, 'columns_to_dense')
    want_bev = JSC.to_dense_bev(jcs, (nx, ny), nz, c)
    assert_close(SC.to_dense_bev(pcs, (nx, ny), nz, c), want_bev, 1e-6,
                 'to_dense_bev')
    # stacked clouds: each cloud's own grid
    two = SC.ColumnSet(*(torch.stack([a, a]) for a in pcs))
    assert_close(SC.to_dense_bev(two, (nx, ny), nz, c)[1], want_bev, 1e-6,
                 'stacked')
