"""What the wrapper of K3's tensor-core kernel prepares, held on the CPU.

The bf16 kernel (streamingflow_tpu_torch/csrc/winfuse.cu) takes its rows at
a channel pitch (``pitch_rows``) and its weights as one (3*cp, Cout) matrix
per in-plane tap (``tap_weights``).  These tests pin both layouts, then walk
the prepared inputs as the kernel does and hold the result against
``subm_conv_plain`` at 1e-5:

  - tiles of 16 output columns, each tap's found source columns staged at
    row z + 1 of their slot between zero z-halo rows, with a zero tail after
    the last slot;
  - items numbered column-major (c*nz + zo) straight across column
    boundaries, 16 to an m16 fragment;
  - the A row of item (c, zo): staged rows zo .. zo + 2 of column c, K =
    3*cp padded to a multiple of 16, against B rows tz*cp + i;
  - a fragment skipped for a tap when none of its columns has the tap
    (src -1), and the row of an item whose column lacks the tap read from
    the zero tail (its slot keeps another step's rows).

Values are bf16-representable fp32, so the products are exact and only the
order of the fp32 sums differs.
"""
import numpy as np
import pytest
import torch

from streamingflow_tpu_torch.ops import winfuse as WF

TILE = 16


def _bf16_exact(x):
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _inputs(cin, cout, nz, n_cols, seed):
    rng = np.random.default_rng(seed)
    rows = n_cols + 7
    # sparse in z as the LiDAR columns are, dense at z = 0 and z = nz - 1 so
    # that the edge items read real values next to the halo
    feats = rng.standard_normal((rows, nz, cin)).astype(np.float32)
    active = rng.random((rows, nz)) < 0.2
    active[:, 0] = active[:, -1] = True
    feats = _bf16_exact((feats * active[..., None]).reshape(rows, -1))
    nbr = torch.from_numpy(rng.integers(0, rows, (9, n_cols))).int()
    found = torch.from_numpy(rng.random((9, n_cols)) < 0.7)
    found[:, 3] = False                   # a column with no tap found
    w = _bf16_exact(rng.standard_normal((27, cin, cout)).astype(np.float32)
                    * (27 * cin) ** -0.5)
    return feats, nbr, found, w


def _kernel_walk(rows, src, b, nz, cp, cout, tile=TILE):
    """The bf16 kernel's walk over prepared inputs, in fp32 on the CPU."""
    n_out = src.shape[1]
    k_rows = b.shape[1]
    b = b.float()
    tail = tile * (nz + 2)
    n_items = tile * nz
    n_frags = -(-n_items // 16)
    it = torch.arange(16 * n_frags)
    col = torch.where(it < n_items, it // nz, tile)
    # staged row of input z = zo - 1 of each item
    arow = torch.where(it < n_items, col * (nz + 2) + it % nz, tail)
    out = torch.zeros(n_out, nz, cout)
    # stale rows where a column has no tap: the kernel never reads them
    staged = torch.full((tail + 4, cp), float('nan'))
    staged[tail:] = 0
    for v0 in range(0, n_out, tile):
        acc = torch.zeros(16 * n_frags, b.shape[2])
        for k in range(9):
            found = torch.zeros(tile + 1, dtype=torch.bool)
            for c in range(tile):
                v = v0 + c
                s = int(src[k, v]) if v < n_out else -1
                if s < 0:
                    continue
                found[c] = True
                at = c * (nz + 2)
                staged[at] = 0
                staged[at + 1:at + 1 + nz] = rows[s].view(nz, cp)
                staged[at + nz + 1] = 0
            row = torch.where(found[col], arow, tail)
            a = torch.cat([staged[row + tz] for tz in range(3)], 1)
            a = torch.cat([a, a.new_zeros(a.shape[0], k_rows - 3 * cp)], 1)
            for f in range(n_frags):
                if not found[col[16 * f:16 * f + 16]].any():
                    continue                      # the kernel skips it
                acc[16 * f:16 * f + 16] += a[16 * f:16 * f + 16] @ b[k]
        for i in range(n_items):
            v = v0 + i // nz
            if v < n_out:
                out[v, i % nz] = acc[i, :cout]
    return out.reshape(n_out, nz * cout)


@pytest.mark.parametrize('cin,cout', [(5, 16), (16, 16), (32, 32), (12, 7),
                                      (32, 17)])
def test_tap_weights_layout(cin, cout):
    rng = np.random.default_rng(cin * 100 + cout)
    w = _bf16_exact(rng.standard_normal((27, cin, cout)).astype(np.float32))
    cp = WF.channel_pitch(cin)
    b = WF.tap_weights(w, cp)
    k_rows = -(-3 * cp // 16) * 16
    n_cols = 16 if cout <= 16 else 32
    assert b.dtype == torch.bfloat16
    assert tuple(b.shape) == (9, k_rows, n_cols)
    want = torch.zeros(9, k_rows, n_cols)
    for k in range(9):
        for tz in range(3):
            want[k, tz * cp:tz * cp + cin, :cout] = w[3 * k + tz]
    assert torch.equal(b.float(), want)


@pytest.mark.parametrize('cin', [5, 8, 12, 16, 32])
def test_pitch_rows(cin):
    nz = 7
    cp = WF.channel_pitch(cin)
    feats = torch.arange(3 * nz * cin, dtype=torch.float32).view(3, -1)
    got = WF.pitch_rows(feats, nz, cp)
    assert tuple(got.shape) == (3, nz * cp)
    view = got.view(3, nz, cp)
    assert torch.equal(view[..., :cin], feats.view(3, nz, cin))
    assert not view[..., cin:].any()
    if cin == cp:
        assert got.data_ptr() == feats.data_ptr()   # no copy


@pytest.mark.parametrize('nz', [41, 21, 25])
@pytest.mark.parametrize('cin', [5, 16, 32])
def test_prepared_walk_matches_plain(cin, nz):
    cout = 16 if cin < 32 else 32
    n_cols = 37                           # 3 tiles, the last one partial
    feats, nbr, found, w = _inputs(cin, cout, nz, n_cols, seed=cin + nz)
    cp = WF.channel_pitch(cin)
    src = torch.where(found, nbr, -1)
    got = _kernel_walk(WF.pitch_rows(feats, nz, cp), src,
                       WF.tap_weights(w, cp), nz, cp, cout)
    want = WF.subm_conv_plain(feats, nbr, found, w, nz)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_route_by_dtype():
    assert WF.route(torch.bfloat16).startswith('tensor cores')
    # fp32 in 3xTF32 on the tensor cores at every width: the narrow kernel
    # up to 32 channels, the wide one past them
    assert WF.route(torch.float32, 32, 32).startswith('tensor cores')
    assert '3xTF32' in WF.route(torch.float32, 16, 32)
    assert WF.route(torch.float32, 64, 64) == \
        'tensor cores (mma.sync 3xTF32, fp32 sums), wide kernel'
    assert 'wide' not in WF.route(torch.float32, 32, 32)


def _staged_w_s(b, cp, nt):
    """The narrow kernel's prologue, element for element: w_s of
    tap_weights' (9, K, 8*nt) B as it stages it, (9, K/16, nt/2, 32, 4, 2)
    (lane, word, half of each 16-byte fragment load)."""
    k_pad = b.shape[1]
    out = torch.zeros(9 * (k_pad // 16) * (nt // 2) * 32 * 8,
                      dtype=b.dtype)
    flat = b.reshape(-1, 8 * nt)
    for kr in range(flat.shape[0]):
        kk = kr % k_pad
        kin = kk % 16
        for nt_i in range(nt):
            frag = ((kr // k_pad * (k_pad // 16) + kk // 16) * (nt // 2)
                    + nt_i // 2) * 32
            word = (nt_i % 2) * 2 + kin // 8
            for c in range(8):
                ln = frag + 4 * c + (kin % 8) // 2
                out[(ln * 4 + word) * 2 + kin % 2] = flat[kr, 8 * nt_i + c]
    return out.view(9, k_pad // 16, nt // 2, 32, 4, 2)


@pytest.mark.parametrize('cin,cp,nz', [(20, 32, 5), (40, 64, 200)])
def test_wide_weights_are_the_narrow_kernels_fragment_order(cin, cp, nz):
    """wide_tap_weights lays out each chunk of 64*groups output channels as
    the narrow kernel's prologue stages w_s for 8*groups n-tiles, so the
    wide kernel's 16-byte loads of a (chunk, tap) feed the same fragment
    order (groups 2 at nz 5, 1 past nz 128: two chunks of 64)."""
    rng = np.random.default_rng(1)
    cout = 72
    w = torch.from_numpy(rng.standard_normal((27, cin, cout)).astype(
        np.float32))
    groups = WF.wide_groups(cout, nz)
    assert groups == (2 if nz <= 128 else 1)
    width = 64 * groups
    chunks = -(-cout // width)
    wide = WF.wide_tap_weights(w, cp, nz)
    assert tuple(wide.shape) == (chunks, 9, 3 * cp // 16, 4 * groups, 32,
                                 4, 2)
    padded = torch.cat([w, w.new_zeros(27, cin, chunks * width - cout)], 2)
    for chunk in range(chunks):
        # the chunk's B: tap_weights of its 32-channel slices side by side
        # (cp is a multiple of 16, so K = 3*cp)
        b = torch.cat([WF.tap_weights(padded[..., j:j + 32], cp)
                       for j in range(width * chunk, width * chunk + width,
                                      32)], 2)
        assert torch.equal(wide[chunk], _staged_w_s(b, cp, 8 * groups)), \
            chunk


@pytest.mark.parametrize('cin,cout,pitches', [
    (64, 64, (64, 64)), (128, 128, (128, 128)), (16, 100, (32, 128)),
    (16, 16, (16, 16)), (5, 32, (8, 32))])
def test_wgrad_rows_take_the_wide_pitches_past_32_channels(cin, cout,
                                                            pitches):
    nz = 3
    feats = torch.randn(4, nz * cin).to(torch.bfloat16)
    g = torch.randn(4, nz * cout).to(torch.bfloat16)
    rows, cp, g_rows, np_ = WF.wgrad_rows(feats, g, nz)
    assert (cp, np_) == pitches
    assert WF.is_wide(cin, cout) == (max(cin, cout) > 32)
    assert tuple(rows.shape) == (4, nz * cp)
    assert torch.equal(rows.view(4, nz, cp)[..., :cin],
                       feats.view(4, nz, cin))
    assert float(g_rows.view(4, nz, np_)[..., cout:].abs().sum()) == 0
