"""What K3's wide bf16 kernels (past 32 channels in or out) read, held on
the CPU.

The wide forward (streamingflow_tpu_torch/csrc/winfuse.cu, namespace wide)
takes its rows at a pitch of 32, 64 or 128 channels (``pitch_rows``) and its
weights as ``wide_tap_weights`` lays them out: chunks of 64*groups output
channels, each (tap, z tap) one contiguous slab of B fragments.  Its items
run z-major (zo*tile + c); it stages the rows of a tap's found source
columns, in feats' own order (row c*nz + z of a tile): up to 32 z only
those that are not all zero, past it every z.  The lane of item (c, zo) at
z tap tz reads row c*nz + zo + tz - 1, or zeros where that z leaves the
column or the row was not staged.  The wide d weights
(csrc/winfuse_wgrad.cu, namespace wide) list each chunk's nonzero
cotangent items once, then cut dW into pieces (tap, z taps) by every
output channel, one block row a piece, and add the blocks' partials in
block order.

These tests walk the prepared inputs as the kernels do and hold the result
against ``subm_conv_plain`` / ``subm_conv_wgrad_plain`` at 1e-5, at 64 and
128 channels, nz 5, 11 and past 32, with a ragged last tile or chunk and
columns without a tap.  Values are bf16-representable fp32, so the products are
exact and only the order of the fp32 sums differs.
"""
import numpy as np
import pytest
import torch

from streamingflow_tpu_torch.ops import winfuse as WF

MAX_SMEM = 232448                      # bytes a block may have on an H100


def _bf16_exact(x):
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _inputs(cin, cout, nz, n_cols, seed, density=0.3):
    rng = np.random.default_rng(seed)
    rows = n_cols + 5
    feats = rng.standard_normal((rows, nz, cin)).astype(np.float32)
    active = rng.random((rows, nz)) < density
    active[:, 0] = active[:, -1] = True   # real values next to the z edges
    feats = _bf16_exact((feats * active[..., None]).reshape(rows, -1))
    # a source row is read by one column a tap at most, as in a column map
    nbr = torch.from_numpy(np.stack([rng.permutation(rows)[:n_cols]
                                     for _ in range(9)])).int()
    found = torch.from_numpy(rng.random((9, n_cols)) < 0.7)
    found[:, 3] = False                   # a column with no tap found
    found[4, :] = False                   # a tap no column has
    w = _bf16_exact(rng.standard_normal((27, cin, cout)).astype(np.float32)
                    * (27 * cin) ** -0.5)
    g = rng.standard_normal((n_cols, nz, cout)).astype(np.float32)
    g = _bf16_exact((g * (rng.random((n_cols, nz, 1)) < density)).reshape(
        n_cols, -1))
    return feats, nbr, found, w, g


def _tile(cp, groups, nz):
    """Columns of a tile of the wide forward (its launch's rule): the most,
    up to 48, whose items fill at most the 3 fragments of each of the
    8 / groups warps of a channel group, and whose weight slabs (a whole
    tap's where a tap's B is at most 24 KB, else one z tap's; a ring of 4
    up to 16 KB, else 3) and tap row buffers fit in shared memory."""
    tzs = 3 if cp * groups <= 64 else 1
    slots = 4 if tzs == 1 and cp * groups <= 128 else 3
    per_tap = 3 // tzs
    row_bufs = (slots - 1 + 2 * per_tap - 1) // per_tap
    slab = tzs * cp * 64 * groups * 2

    def smem(t):
        return (slots * slab + row_bufs * t * nz * 2 * cp + 2 * cp +
                8 * slots + 4 * (4 * 9 * 48 + 8 * 3 * 16))
    tile = min(48, (8 // groups) * 3 * 16 // nz)
    while tile > 0 and smem(tile) > MAX_SMEM:
        tile -= 1
    return tile


def _slabs(wk, cp, width):
    """wide_tap_weights' fragments back to dense slabs, (chunks, 9, 3, cp,
    width): lane l of step s holds, for n-tile pair p, word w and half h,
    B[16 s + 2 (l % 4) + 8 (w % 2) + h, 8 (2p + w // 2) + l // 4]."""
    chunks = wk.shape[0]
    s = torch.arange(3 * cp // 16).view(-1, 1, 1, 1, 1)
    p = torch.arange(width // 16).view(1, -1, 1, 1, 1)
    lane = torch.arange(32).view(1, 1, 32, 1, 1)
    word = torch.arange(4).view(1, 1, 1, 4, 1)
    half = torch.arange(2).view(1, 1, 1, 1, 2)
    kk = (16 * s + 2 * (lane % 4) + 8 * (word % 2) + half).expand(
        wk.shape[2:])
    n = (8 * (2 * p + word // 2) + lane // 4).expand(wk.shape[2:])
    dense = torch.full((chunks, 9, 3 * cp, width), float('nan'))
    dense[:, :, kk, n] = wk.float()
    assert not dense.isnan().any()        # every element has one place
    return dense.view(chunks, 9, 3, cp, width)


def _forward_walk(rows, src, wk, nz, cp, cout, tile):
    """The wide bf16 kernel's walk over prepared inputs, fp32 on the CPU:
    block row y a chunk of 64*groups channels, tiles of ``tile`` columns,
    items z-major (zo*tile + c), 27 substeps (k, tz) a tile, each a (items
    x cp) @ (cp x width) product of the staged rows and the substep's
    slab.  Up to WIDE_MASK_Z z, only a found column's rows that are not
    all zero are staged (the kernel's row masks); past it no mask is kept
    and every z of a found column is staged.  A lane reads its row when it
    is staged and its z lies in the column, else zeros."""
    n_out = src.shape[1]
    width = wk.shape[3] * 16
    slabs = _slabs(wk, cp, width)
    f3 = rows.float().view(-1, nz, cp)
    if nz <= WF.WIDE_MASK_Z:
        active = (f3 != 0).any(-1)        # the rows' masks: (R, nz)
    else:
        active = torch.ones(f3.shape[:2], dtype=torch.bool)
    n_items = tile * nz
    it = torch.arange(n_items)
    col, zo = it % tile, it // tile
    out = torch.zeros(n_out, nz, slabs.shape[0] * width)
    for y in range(slabs.shape[0]):
        for v0 in range(0, n_out, tile):
            acc = torch.zeros(n_items, width)
            for k in range(9):
                # rows not staged keep another tap's: NaN here, which no
                # lane may read
                staged = torch.full((tile, nz, cp), float('nan'))
                flag = torch.zeros(tile, nz, dtype=torch.bool)
                for c in range(tile):
                    v = v0 + c
                    s = int(src[k, v]) if v < n_out else -1
                    if s >= 0:
                        flag[c] = active[s]
                        staged[c][active[s]] = f3[s][active[s]]
                for tz in range(3):
                    z = zo + tz - 1
                    ok = (z >= 0) & (z < nz)
                    ok[ok.clone()] = flag[col[ok], z[ok]]
                    a = torch.where(ok[:, None],
                                    staged[col, z.clamp(0, nz - 1)], 0.)
                    acc += a @ slabs[y, k, tz]
            n_cols = min(tile, n_out - v0)
            res = acc.view(nz, tile, width)[:, :n_cols].transpose(0, 1)
            out[v0:v0 + n_cols, :, y * width:(y + 1) * width] = res
    return out[..., :cout].reshape(n_out, nz * cout)


# stage 3 (64 -> 64, nz 11) and stage 4 (128 -> 128, nz 5) of the column
# ladder, a mixed pitch at two channel groups, one chunk a group past nz
# 128, and the flagship's 41 z (past the row masks' 32): (cin, cout, nz,
# columns)
WIDE = [(64, 64, 11, 45), (128, 128, 5, 45), (40, 100, 4, 45),
        (24, 72, 130, 9), (64, 128, 41, 9)]


@pytest.mark.parametrize('cin,cout,nz,n_cols', WIDE)
def test_forward_walk_matches_plain(cin, cout, nz, n_cols):
    feats, nbr, found, w, _ = _inputs(cin, cout, nz, n_cols, seed=cin + nz)
    cp = WF.wide_pitch(cin)
    groups = WF.wide_groups(cout, nz)
    tile = _tile(cp, groups, nz)
    assert n_cols % tile                  # a ragged last tile
    src = torch.where(found, nbr, -1)
    got = _forward_walk(WF.pitch_rows(feats, nz, cp), src,
                        WF.wide_tap_weights(w, cp, nz), nz, cp, cout, tile)
    want = WF.subm_conv_plain(feats, nbr, found, w, nz)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('cin,cout,nz,n_cols', WIDE[:2] + WIDE[4:])
def test_dgrad_walk_matches_plain(cin, cout, nz, n_cols):
    """d feats: the same kernel over the reversed map with the flipped
    weights (Cin' = Cout, Cout' = Cin)."""
    feats, nbr, found, w, g = _inputs(cin, cout, nz, n_cols, seed=cin - nz)
    src_t = WF.reverse_map(nbr, found, feats.shape[0])
    flipped = WF.flipped_weights(w)
    cp = WF.wide_pitch(cout)
    tile = _tile(cp, WF.wide_groups(cin, nz), nz)
    got = _forward_walk(WF.pitch_rows(g, nz, cp), src_t,
                        WF.wide_tap_weights(flipped, cp, nz), nz, cp, cin,
                        tile)
    x = feats.clone().requires_grad_()
    WF.subm_conv_plain(x, nbr, found, w, nz).backward(g)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('cout,nz,groups,chunks', [
    (64, 11, 1, 1), (128, 5, 2, 1), (72, 128, 2, 1), (128, 129, 1, 2),
    (40, 5, 1, 1)])
def test_channel_groups(cout, nz, groups, chunks):
    assert WF.wide_groups(cout, nz) == groups
    w = torch.zeros(27, 64, cout)
    assert WF.wide_tap_weights(w, 64, nz).shape[0] == chunks
    # every tile the rule allows fits; the flagship's stage 3 at 34 columns
    # (24 of 24 fragments), stage 4 at 38 (12 of 12)
    assert _tile(128, groups, nz) >= 1
    assert _tile(64, WF.wide_groups(64, 11), 11) == 34
    assert _tile(128, WF.wide_groups(128, 5), 5) == 38


def _wgrad_walk(rows, src, g_rows, nz, cp, np_, cin, cout, tv, grid):
    """The wide bf16 d weights' walk over prepared inputs, fp32 on the CPU:
    each chunk of tv columns lists its items whose cotangent row is not
    all zero (-0 counting as zero), ascending; block (x, y) sums piece y
    (tap k, z taps tz0 .. tz0 + TZ - 1, every output channel) over the
    listed items of chunks x, x + grid, ... in 16-item steps; the blocks'
    partials add in block order."""
    n_out = src.shape[1]
    tz_n = 3 if 3 * cp * np_ <= 64 * 256 else 1
    assert WF.wgrad_pieces(cp, np_) == 9 * 3 // tz_n
    f3 = rows.float().view(-1, nz, cp)
    gv = g_rows.float().view(n_out, nz, np_)
    n_chunks = -(-n_out // tv)
    lists = [(gv[c * tv:(c + 1) * tv] != 0).any(-1).reshape(-1).nonzero()
             .squeeze(1) for c in range(n_chunks)]
    parts = torch.zeros(grid, 27, cin, cout)
    for y in range(WF.wgrad_pieces(cp, np_)):
        k, tz0 = y // (3 // tz_n), tz_n * (y % (3 // tz_n))
        for x in range(grid):
            acc = torch.zeros(tz_n * cp, np_)
            for chunk in range(x, n_chunks, grid):
                items = lists[chunk]
                v = chunk * tv + items // nz
                zo = items % nz
                s = src[k, v].long()
                for a0 in range(0, items.numel(), 16):
                    sl = slice(a0, a0 + 16)
                    a = torch.zeros(items[sl].numel(), tz_n, cp)
                    for t in range(tz_n):
                        z = zo[sl] - 1 + tz0 + t
                        ok = (s[sl] >= 0) & (z >= 0) & (z < nz)
                        a[ok, t] = f3[s[sl][ok], z[ok]]
                    acc += a.reshape(-1, tz_n * cp).t() @ gv[v[sl], zo[sl]]
            parts[x, 3 * k + tz0:3 * k + tz0 + tz_n] = \
                acc.view(tz_n, cp, np_)[:, :cin, :cout]
    out = torch.zeros(27, cin, cout)
    for x in range(grid):
        out += parts[x]
    return out


@pytest.mark.parametrize('tv,grid', [(7, 3), (64, 1)])
@pytest.mark.parametrize('cin,cout,nz', [(64, 64, 11), (128, 128, 5),
                                         (20, 64, 7), (100, 40, 5)])
def test_wgrad_walk_matches_plain(cin, cout, nz, tv, grid):
    feats, nbr, found, _, g = _inputs(cin, cout, nz, 45, seed=cin * cout)
    rows, cp, g_rows, np_ = WF.wgrad_rows(feats.to(torch.bfloat16),
                                          g.to(torch.bfloat16), nz)
    src = torch.where(found, nbr, -1)
    got = _wgrad_walk(rows, src, g_rows, nz, cp, np_, cin, cout, tv, grid)
    want = WF.subm_conv_wgrad_plain(feats.double(), nbr, found, g.double(),
                                    nz)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_wgrad_list_takes_negative_zero_as_zero():
    """A row of -0 (a negative value times the zero mask) lists nothing;
    the list's scratch holds a list and a count a chunk."""
    nz, cout = 5, 64
    g = torch.zeros(10, nz, cout)
    g[2, 1] = -0.0
    g[7, 3, 5] = 1.0
    gv = g.to(torch.bfloat16).view(10, nz, cout)
    listed = (gv != 0).any(-1).reshape(-1).nonzero().squeeze(1)
    assert listed.tolist() == [7 * nz + 3]
    tv = WF.wgrad_chunk_columns(nz)
    assert tv == 409
    assert WF.wgrad_list_ints(10, nz) == 10 * 409 * 0 + 409 * nz + 1
    assert WF.wgrad_list_ints(1000, nz) == 3 * 409 * nz + 3


@pytest.mark.parametrize('cin,cout,pieces', [
    (64, 64, 9), (128, 128, 27), (20, 64, 9), (64, 128, 27), (128, 32, 9)])
def test_wgrad_pieces_and_partials(cin, cout, pieces):
    cp, np_ = WF.wide_pitch(cin), WF.wide_pitch(cout)
    assert WF.wgrad_pieces(cp, np_) == pieces
    # the partials' scratch: two blocks an SM, shared by the block rows
    # (the bf16 and fp32 kernels cut dW into the same pieces)
    assert WF.wgrad_parts(132, cin, cout) == max(1, 264 // pieces)
    assert WF.wgrad_parts(132, 32, 32) == 264
