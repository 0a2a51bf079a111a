"""What K3's fp32 kernels up to 32 channels (3xTF32 on the tensor cores)
read and compute, held on the CPU.

The fp32 forward (streamingflow_tpu_torch/csrc/winfuse_tf32.cuh) takes its
rows at a channel pitch of 8, 16 or 32 (``pitch_rows``) and B as
``tf32_tap_weights`` lays it out.  Items run column-major (c*nz + zo) in
fragments of 16, R a warp; a tap's found columns are staged between zero
z-halo rows, a column without the tap keeps another tap's rows and its
lanes read the zero tail instead, and a warp skips a tap none of its
fragments' columns has.  In k8 step s of z tap tz the lane (g, t) of a
fragment row holds the row's values at channels ``tf32_channels(cp)[t,
s]`` (a0) and ``[t, S + s]`` (a2), read from 16-byte chunks of the staged
row.  The fp32 d weights
(csrc/winfuse_wgrad_tf32.cuh) list each chunk's nonzero cotangent items,
one warp a tap sums 8 of them a k8 step from staged source rows (zeros
where there is no row), and the blocks' partials add in block order.

Every product runs in 3xTF32: each value splits into hi = its TF32
rounding (10 stored mantissa bits, ties away from zero, as cvt.rna) and
lo = the rest rounded the same way, and the sum takes lo*hi + hi*lo +
hi*hi.  The walks below do the same arithmetic in fp32 on the CPU and are
held against ``subm_conv_plain`` / ``subm_conv_wgrad_plain`` at 1e-5; the
kernels themselves are held to their plain versions on the card by
chip_smoke.py's ``winfuse`` phase.
"""
import numpy as np
import pytest
import torch

from streamingflow_tpu_torch.ops import winfuse as WF

from torch_parity import fp32_column_inputs as _inputs
from torch_parity import mma3, tf32_rna
from torch_parity import tf32_split as split

MAX_SMEM = 232448                      # bytes a block may have on an H100


def _rounds(tile, nz):
    """Fragments a warp of the fp32 forward works: ceil(frags / 8), rounded
    up to an instantiation (1, 2, 3 or 6)."""
    r = -(-(-(-tile * nz // 16)) // 8)
    return r if r <= 3 else 6


def _tile(cp, cout, nz):
    """(columns of a tile, ring steps) of the fp32 forward's launch
    (csrc/winfuse_tf32.cuh's tile_columns and ring_steps): a ring of at
    least 3 steps where one fits, then the fewest fragment rounds a column
    (_rounds / tile), then the most columns, up to 32; the ring as deep as
    shared memory allows, up to 6."""
    nt = 2 if cout <= 16 else 4
    w_bytes = 9 * 3 * (cp // 8) * (nt // 2) * 32 * 16

    def ring(tile):
        return next((r for r in range(6, 1, -1) if w_bytes + r * (
            (tile * (nz + 2) + 4) * 4 * cp + 20) +
            4 * 8 * _rounds(tile, nz) * 17 <= MAX_SMEM), 0)
    best = None
    for tile in range(1, 33):
        if -(-tile * nz // 16) > 8 * (12 // nt) or ring(tile) == 0:
            break
        key = (ring(tile) < 3, _rounds(tile, nz) / tile, -tile)
        if best is None or key <= best[0]:
            best = (key, tile)
    return best[1], ring(best[1])


def _decode_b(wk):
    """tf32_tap_weights' values back to per-step B, (9, 3S, 8 k slots, n):
    lane 4g + t, word q of pair p is k slot t + 4 (q % 2) of n-tile
    2p + q // 2, column g."""
    taps, steps, pairs = wk.shape[:3]
    b = torch.full((taps, steps, 8, 16 * pairs), float('nan'))
    lane = torch.arange(32).view(32, 1)
    q = torch.arange(4).view(1, 4)
    for p in range(pairs):
        b[:, :, lane % 4 + 4 * (q % 2), 8 * (2 * p + q // 2) + lane // 4] = \
            wk[:, :, p]
    assert not b.isnan().any()            # every value has one place
    return b


def _lane_words(r, cp):
    """row_words of the kernel: lane t's values of staged rows r (M, cp),
    (M, 4, 2S): chunks t and t + 4 at cp 32, chunk t at 16, 8 bytes at
    8t at 8."""
    if cp == 32:
        return torch.stack([torch.cat([r[:, 4 * t:4 * t + 4],
                                       r[:, 16 + 4 * t:20 + 4 * t]], 1)
                            for t in range(4)], 1)
    n = 4 if cp == 16 else 2
    return r.view(-1, 4, n)


def _forward_walk(rows, src, wk, nz, cp, cout, tile):
    """The fp32 forward's walk over prepared inputs in fp32 on the CPU:
    tiles of ``tile`` columns, 9 steps (taps) a tile, each fragment of 16
    items (column-major, across columns) 3 z taps x S k8 steps of 3xTF32
    products; warp w works fragments w, w + 8, ... (R of them, some past
    the items) and skips a step only when none of their columns has the
    tap; a column whose tap is not found keeps stale rows (NaN here, which
    no lane may read) and its lanes read the zero tail."""
    n_out, s_n = src.shape[1], cp // 8
    b = _decode_b(wk)
    n = b.shape[3]
    f3 = rows.view(-1, nz, cp)
    n_items = tile * nz
    rounds = _rounds(tile, nz)
    n_frags = 8 * rounds
    it = torch.arange(n_frags * 16)
    col = torch.where(it < n_items, it // nz, -1)
    row0 = col * (nz + 2) + it % nz       # staged row of input z = zo - 1
    tail = tile * (nz + 2)
    out = torch.zeros(n_out, nz, n)
    for v0 in range(0, n_out, tile):
        acc = torch.zeros(n_frags * 16, n)
        srcs = torch.full((9, tile), -1, dtype=torch.int32)
        srcs[:, :min(tile, n_out - v0)] = src[:, v0:v0 + tile]
        for k in range(9):
            staged = torch.zeros(tail + 4, cp)
            body = f3[srcs[k].long().clamp(min=0)]
            body[srcs[k] < 0] = float('nan')
            staged[:tail].view(tile, nz + 2, cp)[:, 1:nz + 1] = body
            fnd = torch.cat([srcs[k] >= 0, torch.zeros(1, dtype=torch.bool)])
            lane_row = torch.where(fnd[col], row0, tail)
            # fragment 8f + w is warp w's f-th: (R, 8 warps, 16 items)
            warp_live = fnd[col].view(rounds, 8, 16).any(2).any(0)
            live = warp_live.view(1, 8, 1).expand(rounds, 8, 16).reshape(-1)
            for tz in range(3):
                v = _lane_words(staged[lane_row + tz], cp)
                for s in range(s_n):
                    # a0 / a1: k slot t, a2 / a3: k slot t + 4
                    a = torch.cat([v[:, :, s], v[:, :, s_n + s]], 1)
                    acc[live] = mma3(acc[live], a[live], b[k, tz * s_n + s])
        n_cols = min(tile, n_out - v0)
        out[v0:v0 + n_cols] = acc[:n_cols * nz].view(n_cols, nz, n)
    return out[..., :cout].reshape(n_out, nz * cout)


# conv_input (5 -> 16, pitch 8) and stage 1 (16 -> 16) at the flagship's
# nz 41, stage 2 (32 -> 32, nz 21), and two odd widths: (cin, cout, nz,
# columns)
FORWARD = [(5, 16, 41, 40), (16, 16, 41, 40), (32, 32, 21, 27),
           (20, 12, 7, 45), (32, 8, 5, 60)]


@pytest.mark.parametrize('cin,cout,nz,n_cols', FORWARD)
def test_forward_walk_matches_plain(cin, cout, nz, n_cols):
    feats, nbr, found, w, _ = _inputs(cin, cout, nz, n_cols, seed=cin + nz)
    cp = WF.channel_pitch(cin)
    tile, _ = _tile(cp, cout, nz)
    assert n_cols % tile                  # a ragged last tile
    got = _forward_walk(WF.pitch_rows(feats, nz, cp),
                        torch.where(found, nbr, -1),
                        WF.tf32_tap_weights(w, cp), nz, cp, cout, tile)
    want = WF.subm_conv_plain(feats, nbr, found, w, nz)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize('cin,cout,nz,n_cols', [FORWARD[1], FORWARD[2]])
def test_dgrad_walk_matches_plain(cin, cout, nz, n_cols):
    """d feats: the same kernel over the reversed map with the flipped
    weights (Cin' = Cout, Cout' = Cin)."""
    feats, nbr, found, w, g = _inputs(cin, cout, nz, n_cols, seed=2 * cin + nz)
    src_t = WF.reverse_map(nbr, found, feats.shape[0])
    cp = WF.channel_pitch(cout)
    got = _forward_walk(WF.pitch_rows(g, nz, cp), src_t,
                        WF.tf32_tap_weights(WF.flipped_weights(w), cp), nz,
                        cp, cin, _tile(cp, cin, nz)[0])
    x = feats.clone().requires_grad_()
    WF.subm_conv_plain(x, nbr, found, w, nz).backward(g)
    scale = float(x.grad.abs().max())
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-5 * scale)


def test_tiles_of_the_main_path():
    """The flagship's tiles (stage 2: 12 columns, 16 fragments, 2 a warp;
    stages 1 and conv_input at nz 41: 18 columns, 47 of 48 fragments), the
    ring each leaves room for and the d weights' chunks; every B layout's
    shape."""
    assert _tile(32, 32, 21) == (12, 3)
    assert _tile(16, 16, 41) == (18, 4)
    assert _tile(8, 16, 41) == (18, 6)
    # the d weights' chunks: stage 2, stage 1, conv_input (Cin 5 at pitch 8)
    assert _chunk_columns(32, 32, 21) == 25
    assert _chunk_columns(16, 16, 41) == 31
    assert _chunk_columns(8, 16, 41) == 36
    for cp, cout in ((8, 16), (16, 16), (32, 32), (32, 8)):
        wk = WF.tf32_tap_weights(torch.zeros(27, cp, cout), cp)
        assert wk.shape == (9, 3 * cp // 8, 1 if cout <= 16 else 2, 32, 4)
        # each lane's values of a z row are each channel once a k8 step
        ch = WF.tf32_channels(cp)
        for s in range(cp // 8):
            slots = torch.cat([ch[:, s], ch[:, cp // 8 + s]])
            assert slots.unique().numel() == 8
        assert ch.flatten().sort().values.tolist() == list(range(cp))


def _chunk_columns(cp, np_, nz):
    """Columns of a chunk of the fp32 d weights (its launch's rule): the
    most, up to 64, whose two cotangent buffers, the 9 warps' rings of 3 x
    8 staged items and the lists fit in shared memory."""
    a_words = (16 * -(-3 * cp // 16) - 8 + 31) // 32 * 32 + 8
    for tv in range(64, 0, -1):
        items = tv * nz
        if (2 * items * 4 * np_ + 4 * 9 * 3 * 8 * a_words + 128 + 16 +
                4 * (items + 2 * (-(-items // 32)) + 9 * tv + 1)) <= MAX_SMEM:
            return tv
    return 1


def _wgrad_walk(rows, src, g_rows, nz, cp, np_, cin, cout, tv, grid):
    """The fp32 d weights' walk over prepared inputs in fp32 on the CPU:
    each chunk of tv columns lists its items whose cotangent row is not all
    zero (-0 counting as zero), ascending; block x, warp k sums dW_k over
    the listed items of chunks x, x + grid, ... 8 items a k8 step (3xTF32),
    each staged as its source rows zo - 1 .. zo + 1 (zeros where the column
    lacks the tap, z leaves it or the item is past the list); the blocks'
    partials add in block order."""
    n_out = src.shape[1]
    m_pad = 16 * -(-3 * cp // 16)         # the m-tiles' rows (tz, i)
    f3 = rows.view(-1, nz, cp)
    gv = g_rows.view(n_out, nz, np_)
    n_chunks = -(-n_out // tv)
    lists = [(gv[c * tv:(c + 1) * tv] != 0).any(-1).reshape(-1).nonzero()
             .squeeze(1) for c in range(n_chunks)]
    parts = torch.zeros(grid, 27, cin, cout)
    for x in range(grid):
        for k in range(9):
            acc = torch.zeros(m_pad, np_)
            for chunk in range(x, n_chunks, grid):
                items = lists[chunk]
                v = chunk * tv + items // nz
                zo = items % nz
                for a0 in range(0, items.numel(), 8):
                    sl = slice(a0, a0 + 8)
                    staged = torch.zeros(8, m_pad)
                    bm = torch.zeros(8, np_)
                    n = items[sl].numel()
                    s = src[k, v[sl]].long()
                    for tz in range(3):
                        z = zo[sl] - 1 + tz
                        ok = (s >= 0) & (z >= 0) & (z < nz)
                        staged[:n][ok, tz * cp:(tz + 1) * cp] = \
                            f3[s[ok], z[ok]]
                    bm[:n] = gv[v[sl], zo[sl]]
                    acc = mma3(acc, staged.t(), bm)
            parts[x, 3 * k:3 * k + 3] = \
                acc[:3 * cp].view(3, cp, np_)[:, :cin, :cout]
    out = torch.zeros(27, cin, cout)
    for x in range(grid):
        out += parts[x]
    return out


@pytest.mark.parametrize('cin,cout,nz,grid', [
    (5, 16, 41, 3), (16, 16, 41, 2), (32, 32, 21, 3), (20, 12, 7, 1)])
def test_wgrad_walk_matches_plain(cin, cout, nz, grid):
    feats, nbr, found, _, g = _inputs(cin, cout, nz, 45, seed=cin * cout)
    rows, cp, g_rows, np_ = WF.wgrad_rows(feats, g, nz)
    tv = min(_chunk_columns(cp, np_, nz), 9)  # several chunks a block
    got = _wgrad_walk(rows, torch.where(found, nbr, -1), g_rows, nz, cp,
                      np_, cin, cout, tv, grid)
    want = WF.subm_conv_wgrad_plain(feats.double(), nbr, found, g.double(),
                                    nz)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_tf32_rounding_is_cvt_rna():
    """Ties away from zero, 10 stored mantissa bits, signs apart."""
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's step at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2e-7,
                      one + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, -0.0]
    assert tf32_rna(x).tolist() == want
    hi, lo = split(torch.tensor([1 / 3], dtype=torch.float32))
    # hi and lo keep 11 + 11 significant bits of the 24
    assert abs(float(hi) + float(lo) - float(np.float32(1 / 3))) <= \
        2.0 ** -22 / 3


@pytest.mark.parametrize('depth,bar', [(27 * 32, 1e-5), (8192, 1e-4)])
def test_three_pass_sums_within_the_card_bars(depth, bar):
    """Sums of ``depth`` products (stage 2's forward: 27 taps x 32
    channels, held at 1e-5; d weights' item depth, held at 1e-4) in
    3xTF32, k8 step by k8 step in fp32 as the mma run, against the fp64
    sums: within the card's bar of the scale.  One-pass TF32 (hi * hi)
    lands an order of magnitude or more beyond it, printed beside."""
    rng = np.random.default_rng(depth)
    a = rng.standard_normal((64, depth)).astype(np.float32)
    b = (rng.standard_normal((depth, 32)) * depth ** -0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    three = torch.zeros(64, 32)
    one = torch.zeros(64, 32)
    for k0 in range(0, depth, 8):
        ak, bk = at[:, k0:k0 + 8], bt[k0:k0 + 8]
        three = mma3(three, ak, bk)
        one += tf32_rna(ak) @ tf32_rna(bk)
    scale = np.abs(exact).max()
    err3 = float(np.abs(three.double().numpy() - exact).max()) / scale
    err1 = float(np.abs(one.double().numpy() - exact).max()) / scale
    fp32 = float(np.abs((at @ bt).double().numpy() - exact).max()) / scale
    print(f'depth {depth}: 3xTF32 {err3:.3g}, fp32 {fp32:.3g}, one-pass '
          f'TF32 {err1:.3g} of the scale (bar {bar})')
    assert err3 <= bar / 10
    assert err1 > bar
