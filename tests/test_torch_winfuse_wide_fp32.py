"""What K3's fp32 kernels past 32 channels (3xTF32 on the tensor cores)
read and compute, held on the CPU.

The wide fp32 forward (streamingflow_tpu_torch/csrc/winfuse_wide_tf32.cuh)
takes its rows at a pitch of 32, 64 or 128 channels (``pitch_rows``) and B
as ``wide_tf32_tap_weights`` lays it out: chunks of 64 output channels,
each (tap, 32-channel block, z tap) one contiguous slab.  Its
items run z-major (zo*tile + c) in fragments of 16; a row step (tap,
32-channel block) stages the rows of its found source columns that are not
all zero (-0 counting as zero; past 32 z every z of a found column), 32
channels of each; the lane of item (c, zo) at z tap tz reads row c*nz +
zo + tz - 1, or zeros where that z leaves the column or the row was not
staged, and a fragment none of whose rows is staged skips the z tap.  In
k8 step s of a 32-channel block, lane t holds as a0 / a2 the channels
``tf32_channels(32)`` names (two 16-byte chunks of the block), and B
arrives split into TF32 hi and lo.
The wide fp32 d weights (csrc/winfuse_wgrad_wide_tf32.cuh) list each
chunk's nonzero cotangent items once, cut dW into pieces (tap, z taps) by
every output channel, one block row a piece, sum 8 listed items a k8 step,
add their sums into their partials every 1024 listed items or so (the
tensor cores round each mma's sum toward zero) and add the blocks'
partials in block order.

The walks below do the kernels' 3xTF32 arithmetic in fp32 on the CPU
(``torch_parity.mma3``) and are held against ``subm_conv_plain`` /
``subm_conv_wgrad_plain`` at 1e-5 of the scale; one case holds the port's
conv and the walk against the TPU kernel itself in interpret mode.  The
kernels themselves are held to their plain versions on the card by
chip_smoke.py's ``winfuse`` phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.ops import pallas_winfuse as JWF
from streamingflow_tpu.ops import sparse_columns as JSC
from streamingflow_tpu_torch.ops import sparse_columns as SC
from streamingflow_tpu_torch.ops import winfuse as WF

from torch_parity import fp32_column_inputs, mma3, t, tf32_rna

MAX_SMEM = 232448                      # bytes a block may have on an H100
# listed items after which a block of the d weights adds its sums into its
# partial (csrc/winfuse_wgrad_wide_tf32.cuh's kFlushItems)
FLUSH_ITEMS = 1024


def _tile(groups, nz):
    """Columns of a tile of the wide fp32 forward (its launch's rule,
    wide_tf32::tile_columns): the most, up to 96, whose items fill at most
    the 3 fragments of each of the 8 / groups warps of a channel group,
    and whose ring of 4 slabs (16 KB a group) and two row buffers (32
    channels a row) fit in shared memory."""
    def smem(tile):
        return (4 * 16384 * groups + 2 * tile * nz * 128 + 128 + 16 * 4 +
                4 * (4 * 9 * 96 + 8 * 3 * 16 + 2 * 3 * 256))
    tile = min(96, WF.WIDE_TF32_ITEMS // groups // nz)
    while tile > 0 and smem(tile) > MAX_SMEM:
        tile -= 1
    return tile


def _decode_b(wk):
    """wide_tf32_tap_weights' values by k slot, (hi, lo) each (chunks, 9,
    cp/32, 3, 4, 8, width): slot j of k8 step s is b0 (j < 4) or b1
    (j >= 4) of lane 4 g + j % 4 for column 8 nt + g of the chunk, words
    j // 4 (hi) and 2 + j // 4 (lo) of n-tile nt."""
    chunks, taps, blocks, tzs, steps, n_tiles = wk.shape[:6]
    out = []
    for word0 in (0, 2):
        b = torch.full((chunks, taps, blocks, tzs, steps, 8, 8 * n_tiles),
                       float('nan'))
        for j in range(8):
            for nt in range(n_tiles):
                for g in range(8):
                    b[..., j, 8 * nt + g] = \
                        wk[..., nt, 4 * g + j % 4, word0 + j // 4]
        assert not b.isnan().any()        # every value has one place
        out.append(b)
    return tuple(out)


def _k_slots(rows, s):
    """(M, 8): the values of staged 32-channel rows (M, 32) lane t holds in
    k8 step s (a0 in slot t, a2 in slot t + 4), read as the kernel does:
    chunks t and t + 4 of the row, value s of each."""
    lo = [rows[:, 4 * t + s] for t in range(4)]
    hi = [rows[:, 16 + 4 * t + s] for t in range(4)]
    return torch.stack(lo + hi, 1)


def _forward_walk(rows, src, wk, nz, cp, cout, tile):
    """The wide fp32 kernel's walk over prepared inputs in fp32 on the CPU:
    block row y a chunk of 64*groups channels, tiles of ``tile`` columns,
    items z-major (zo*tile + c) in fragments of 16, each row step (tap k,
    32-channel block q) staging its marked rows, then its 3 z taps x 4 k8
    steps of 3xTF32 products of the lanes' k slots (split) and the slab's
    split values; a fragment with no staged row at a z tap skips it; each
    tap's sums are added into the tile's outputs."""
    n_out = src.shape[1]
    bh, bl = _decode_b(wk)
    chunks, blocks, width = bh.shape[0], bh.shape[2], bh.shape[-1]
    f3 = rows.view(-1, nz, cp)
    if nz <= WF.WIDE_MASK_Z:
        active = (f3 != 0).any(-1)        # the rows' masks (-0 is zero)
    else:
        active = torch.ones(f3.shape[:2], dtype=torch.bool)
    n_items = tile * nz
    n_frags = -(-n_items // 16)
    it = torch.arange(n_frags * 16)
    col, zo = it % tile, it // tile
    inside = it < n_items
    out = torch.zeros(n_out, nz, chunks * width)
    for y in range(chunks):
        for v0 in range(0, n_out, tile):
            acc = torch.zeros(n_frags * 16, width)
            tot = torch.zeros(n_frags * 16, width)
            for k in range(9):
                for q in range(blocks):
                    # rows not staged keep another row step's: NaN here,
                    # which no lane may read
                    staged = torch.full((tile, nz, 32), float('nan'))
                    flag = torch.zeros(tile, nz, dtype=torch.bool)
                    for c in range(tile):
                        v = v0 + c
                        s = int(src[k, v]) if v < n_out else -1
                        if s >= 0:
                            flag[c] = active[s]
                            staged[c][active[s]] = \
                                f3[s, :, 32 * q:32 * (q + 1)][active[s]]
                    for tz in range(3):
                        z = zo + tz - 1
                        ok = inside & (z >= 0) & (z < nz)
                        ok[ok.clone()] = flag[col[ok], z[ok]]
                        live = ok.view(n_frags, 16).any(1).repeat_interleave(
                            16)
                        a_rows = torch.where(
                            ok[:, None], staged[col, z.clamp(0, nz - 1)], 0.)
                        for s in range(4):
                            acc[live] = mma3(acc[live],
                                             _k_slots(a_rows[live], s),
                                             (bh[y, k, q, tz, s],
                                              bl[y, k, q, tz, s]))
                tot += acc
                acc.zero_()
            n_cols = min(tile, n_out - v0)
            res = tot[:n_items].view(nz, tile, width)[:, :n_cols]
            out[v0:v0 + n_cols, :, y * width:(y + 1) * width] = \
                res.transpose(0, 1)
    return out[..., :cout].reshape(n_out, nz * cout)


def _wgrad_walk(rows, src, g_rows, nz, cp, np_, cin, cout, grid, tv,
                flush_items=FLUSH_ITEMS):
    """The wide fp32 d weights' walk over prepared inputs in fp32 on the
    CPU: each chunk of tv columns lists its items whose cotangent row is
    not all zero (-0 counting as zero), ascending; block (x, y) sums piece
    y (tap k, z taps tz0 .. tz0 + TZ - 1, every output channel) over the
    listed items of chunks x, x + grid, ..., 8 items a k8 step in 3xTF32,
    each staged as its TZ source rows (zeros where the column lacks the
    tap, z leaves it or the item is past the list) and its cotangent row;
    the block adds its sums into its partial after every chunk that brings
    its items since the last add to ``flush_items``, and after its last
    chunk; the blocks' partials add in block order."""
    n_out = src.shape[1]
    pieces = WF.wgrad_pieces(cp, np_)
    tz_n = 27 // pieces
    f3 = rows.view(-1, nz, cp)
    gv = g_rows.view(n_out, nz, np_)
    n_chunks = -(-n_out // tv)
    lists = [(gv[c * tv:(c + 1) * tv] != 0).any(-1).reshape(-1).nonzero()
             .squeeze(1) for c in range(n_chunks)]
    parts = torch.zeros(grid, 27, cin, cout)
    for y in range(pieces):
        k, tz0 = y // (3 // tz_n), tz_n * (y % (3 // tz_n))
        for x in range(grid):
            acc = torch.zeros(tz_n * cp, np_)
            pending = 0
            for chunk in range(x, n_chunks, grid):
                items = lists[chunk]
                v = chunk * tv + items // nz
                zo = items % nz
                s = src[k, v].long()
                for a0 in range(0, items.numel(), 8):
                    sl = slice(a0, a0 + 8)
                    n = items[sl].numel()
                    a = torch.zeros(8, tz_n, cp)
                    bm = torch.zeros(8, np_)
                    for tt in range(tz_n):
                        z = zo[sl] - 1 + tz0 + tt
                        ok = (s[sl] >= 0) & (z >= 0) & (z < nz)
                        a[:n][ok, tt] = f3[s[sl][ok], z[ok]]
                    bm[:n] = gv[v[sl], zo[sl]]
                    acc = mma3(acc, a.reshape(8, -1).t(), bm)
                pending += items.numel()
                if pending >= flush_items or chunk + grid >= n_chunks:
                    parts[x, 3 * k + tz0:3 * k + tz0 + tz_n] += \
                        acc.view(tz_n, cp, np_)[:, :cin, :cout]
                    acc.zero_()
                    pending = 0
    out = torch.zeros(27, cin, cout)
    for x in range(grid):
        out += parts[x]
    return out


def _close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got.double(), want.double(), rtol=1e-5,
                               atol=1e-5 * scale)


# stage 3 (64 -> 64, nz 11) and stage 4 (128 -> 128, nz 5) of the column
# ladder, the flagship's 41 z (past the row masks' 32) at two channel
# groups, and an odd pair at pitch 64 -> 128: (cin, cout, nz, columns)
WIDE = [(64, 64, 11, 45), (128, 128, 5, 45), (64, 128, 41, 7),
        (40, 100, 4, 45)]


@pytest.mark.parametrize('cin,cout,nz,n_cols', WIDE)
def test_forward_walk_matches_plain(cin, cout, nz, n_cols):
    feats, nbr, found, w, _ = fp32_column_inputs(cin, cout, nz, n_cols,
                                                 seed=cin + nz)
    cp = WF.wide_pitch(cin)
    tile = _tile(WF.wide_tf32_groups(cout, nz), nz)
    assert n_cols % tile                  # a ragged last tile
    got = _forward_walk(WF.pitch_rows(feats, nz, cp),
                        torch.where(found, nbr, -1),
                        WF.wide_tf32_tap_weights(w, cp, nz), nz, cp, cout,
                        tile)
    _close(got, WF.subm_conv_plain(feats, nbr, found, w, nz))


@pytest.mark.parametrize('cin,cout,nz,n_cols', [WIDE[0], WIDE[1],
                                                (64, 128, 41, 7)])
def test_dgrad_walk_matches_plain(cin, cout, nz, n_cols):
    """d feats: the same kernel over the reversed map with the flipped
    weights (Cin' = Cout, Cout' = Cin: 128 -> 64 for the last case), on the
    cotangent's rows (-0 at the inactive sites, unstaged)."""
    feats, nbr, found, w, g = fp32_column_inputs(cin, cout, nz, n_cols,
                                                 seed=2 * cin + nz)
    src_t = WF.reverse_map(nbr, found, feats.shape[0])
    cp = WF.wide_pitch(cout)
    got = _forward_walk(WF.pitch_rows(g, nz, cp), src_t,
                        WF.wide_tf32_tap_weights(WF.flipped_weights(w), cp,
                                                 nz), nz, cp, cin,
                        _tile(WF.wide_tf32_groups(cin, nz), nz))
    x = feats.clone().requires_grad_()
    WF.subm_conv_plain(x, nbr, found, w, nz).backward(g)
    _close(got, x.grad)


@pytest.mark.parametrize('cin,cout,nz,grid,tv,flush', [
    (64, 64, 11, 1, None, FLUSH_ITEMS), (128, 128, 5, 2, None, FLUSH_ITEMS),
    (64, 128, 41, 1, None, FLUSH_ITEMS), (100, 40, 7, 3, 4, 16)])
def test_wgrad_walk_matches_plain(cin, cout, nz, grid, tv, flush):
    """The kernel's chunks (wgrad_chunk_columns), and in the last case
    chunks of 4 columns, three a block, added into the partial every 16
    listed items, so that every block walks several chunks and adds
    several times."""
    feats, nbr, found, _, g = fp32_column_inputs(cin, cout, nz, 45,
                                                 seed=cin * cout)
    rows, cp, g_rows, np_ = WF.wgrad_rows(feats, g, nz)
    got = _wgrad_walk(rows, torch.where(found, nbr, -1), g_rows, nz, cp,
                      np_, cin, cout, grid,
                      tv or WF.wgrad_chunk_columns(nz), flush)
    want = WF.subm_conv_wgrad_plain(feats.double(), nbr, found, g.double(),
                                    nz)
    _close(got, want)


def test_tiles_and_layouts_of_the_main_path():
    """The flagship's tail-0 tiles (stage 3: 34 columns, 374 of 384 items;
    stage 4 at two channel groups: 38, 190 of 192; the 41 z at two groups:
    4), the d weights' pieces, and B's layout: a value back from its place,
    split into TF32 hi (the value rounded as cvt.rna, its low 13 bits zero)
    and lo."""
    assert [WF.wide_tf32_groups(c, nz) for c, nz in (
        (64, 11), (128, 5), (128, 41), (128, 193), (72, 192))] == \
        [1, 2, 2, 1, 2]
    assert [_tile(WF.wide_tf32_groups(c, nz), nz) for c, nz in (
        (64, 11), (128, 5), (128, 41), (64, 41), (128, 256))] == \
        [34, 38, 4, 9, 1]
    assert WF.wgrad_pieces(64, 64) == 9 and WF.wgrad_pieces(128, 128) == 27
    ch = WF.tf32_channels(32)
    for cin, cout, nz, shape in (
            (64, 64, 11, (1, 9, 2, 3, 4, 8, 32, 4)),
            (128, 128, 5, (1, 9, 4, 3, 4, 16, 32, 4)),
            (24, 72, 200, (2, 9, 1, 3, 4, 8, 32, 4))):
        cp = WF.wide_pitch(cin)
        w = torch.randn(27, cin, cout)
        wk = WF.wide_tf32_tap_weights(w, cp, nz)
        assert wk.shape == shape
        assert (wk.view(torch.int32) & 0x1FFF).eq(0).all()
        # the last chunk, tap 2, the last block q, z tap 1, k8 step s, lane
        # (g, t), n-tile nt: b1 is channel 32 q + ch[t, 4 + s]
        y, q, s, nt, g, tt = shape[0] - 1, shape[2] - 1, 3, 1, 5, 2
        i = 32 * q + int(ch[tt, 4 + s])
        n = 8 * shape[5] * y + 8 * nt + g
        want = w[7, i, n] if i < cin and n < cout else torch.tensor(0.)
        hi, lo = wk[y, 2, q, 1, s, nt, 4 * g + tt, 1::2]
        assert float(hi) == float(tf32_rna(want.view(1))[0])
        assert float(hi + lo) == pytest.approx(float(want), abs=1e-6)


def test_wide_fp32_conv_matches_pallas_interpret():
    """The port's fp32 conv at 64 -> 64 (on the CPU its plain version) and
    the wide fp32 kernel's walk against the TPU kernel itself
    (pallas_winfuse.subm_conv_winfuse in interpret mode) on one small
    column set, a window plan that drops taps included."""
    shape, cin, cout, cap = (12, 10, 7), 64, 64, 128
    rng = np.random.default_rng(64)
    nx, ny, nz = shape
    cols = rng.choice(nx * ny, 60, replace=False)
    ids = np.unique(np.concatenate(
        [c * nz + rng.choice(nz, rng.integers(1, 5), replace=False)
         for c in cols]))
    n_sites = 512
    idp = np.full(n_sites, np.iinfo(np.int32).max, np.int64)
    idp[:len(ids)] = ids
    mask = np.arange(n_sites) < len(ids)
    feats = rng.normal(size=(n_sites, cin)).astype(np.float32) * \
        mask[:, None]
    jcs = JSC.from_sites(jnp.asarray(feats), jnp.asarray(idp.astype(
        np.int32)), jnp.asarray(mask), shape, cap)
    pcs = SC.from_sites(t(feats), t(idp.astype(np.int32)), t(mask), shape,
                        cap)
    w = (rng.normal(size=(27, cin, cout)) * (27 * cin) ** -0.5).astype(
        np.float32)
    jm = JSC.build_column_map(jcs, shape[:2])
    block, window, resid = 16, 20, 0
    plan = JWF.build_fused_plan(jm, jcs.col_mask, block=block,
                                window=window, resid_blocks=resid)
    want = np.asarray(JWF.subm_conv_winfuse(
        jcs.feats, jcs.zmask, jm, plan, jnp.asarray(w), mask_output=False,
        window=window, interpret=True))
    cmap = SC.build_column_map(pcs, shape[:2])
    found, n_dropped = WF.fused_found(cmap, block, window, resid)
    assert int(n_dropped) == int(plan.n_dropped) > 0
    got = WF.subm_conv_winfuse(pcs.feats, cmap.nbr, found, t(w), nz)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    cp = WF.wide_pitch(cin)
    walk = _forward_walk(WF.pitch_rows(pcs.feats, nz, cp),
                         torch.where(found, cmap.nbr, -1),
                         WF.wide_tf32_tap_weights(t(w), cp, nz), nz, cp,
                         cout, _tile(1, nz))
    np.testing.assert_allclose(walk.numpy(), want, rtol=2e-5, atol=2e-5)
