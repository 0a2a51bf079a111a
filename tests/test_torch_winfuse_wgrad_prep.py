"""What K3's tensor-core d-weights kernel reads, walked on the CPU.

The bf16 kernel (streamingflow_tpu_torch/csrc/winfuse_wgrad.cu) takes its
rows as ``winfuse.wgrad_rows`` prepares them: the features at Cin's channel
pitch (conv_input's 5 channels at 8) and the cotangent at Cout's.  It
computes dW_k = A_k^T B for each in-plane tap k as one GEMM whose depth
runs over the items (column, output z).  These tests walk the prepared
inputs the way the kernel reads them, in torch, and hold the result against
``subm_conv_wgrad_plain`` at 1e-5 of its scale:

  - chunks of tv output columns, walked grid-stride by the blocks; a
    chunk's items c*nz + zo whose cotangent row is not all zero listed in
    ascending order, the list padded to a multiple of 16 (one k16 step)
    with zero rows;
  - for tap k, item (c, zo) stages rows zo - 1 .. zo + 1 of its column's
    source row, so that row tz*cp + i of the staging is A_k's row (tz, i):
    the z shift is a row offset; a row outside the column, a tap not taken
    (src -1) and a pad item read a zero row;
  - m16n8k16 tiles: per k16 step each (16 x 8) tile of dW_k adds the
    product of its 16 (tz, i) rows and 8 output channels over the step's
    16 items;
  - one partial a block (its taps' tiles, cut to Cin x Cout), the partials
    added in block order.

Values are bf16-representable fp32, so the products are exact and only the
order of the fp32 sums differs.  One small case is held against the JAX
package's own gradient too: ``jax.vjp`` of ``subm_conv_winfuse`` with the
Pallas kernel in interpret mode (as tests/test_torch_winfuse_grad.py runs
it).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from streamingflow_tpu.ops import pallas_winfuse as JWF
from streamingflow_tpu.ops import sparse_columns as JSC
from streamingflow_tpu_torch.ops import sparse_columns as SC
from streamingflow_tpu_torch.ops import winfuse as WF

from test_torch_sparse import SHAPE, _columns


def _bf16_exact(x):
    return torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16).float()


def _inputs(cin, cout, nz, n_cols, seed, density=0.15):
    """Column rows sparse in z, a map with ~70% of the taps found, a
    cotangent zero except at ``density`` of the (column, z) sites."""
    rng = np.random.default_rng(seed)
    rows = n_cols + 7
    feats = rng.standard_normal((rows, nz, cin)) * \
        (rng.random((rows, nz, 1)) < 0.4)
    feats = _bf16_exact(feats.reshape(rows, nz * cin))
    nbr = torch.from_numpy(rng.integers(0, rows, (9, n_cols))).int()
    found = torch.from_numpy(rng.random((9, n_cols)) < 0.7)
    found[:, 3] = False                   # a column with no tap found
    g = rng.standard_normal((n_cols, nz, cout)) * \
        (rng.random((n_cols, nz, 1)) < density)
    return feats, nbr, found, _bf16_exact(g.reshape(n_cols, nz * cout))


def _kernel_walk(rows, cp, src, g_rows, np_, nz, cin, cout, tv, n_blocks):
    """The bf16 kernel's walk over its prepared inputs, in fp32."""
    n_out = src.shape[1]
    m_pad = -(-3 * cp // 16) * 16         # M = 3*cp in m16 tiles
    n_chunks = -(-n_out // tv)
    staged = rows.view(-1, nz, cp)
    parts = []
    for block in range(n_blocks):
        acc = torch.zeros(9, m_pad, np_)
        for chunk in range(block, n_chunks, n_blocks):
            v0 = chunk * tv
            nc = min(tv, n_out - v0)
            gs = g_rows[v0:v0 + nc].view(nc * nz, np_)
            items = torch.nonzero(gs.ne(0).any(1)).squeeze(1)  # ascending
            n_pad = -(-items.numel() // 16) * 16
            live = torch.arange(n_pad) < items.numel()
            it = torch.cat([items, items.new_zeros(n_pad - items.numel())])
            c, zo = it // nz, it % nz
            b = torch.where(live[:, None], gs[it], 0.)
            for k in range(9):
                s = torch.where(live, src[k, v0 + c], -1).long()
                a = torch.zeros(n_pad, 3, cp)
                for tz in range(3):
                    z = zo + tz - 1
                    ok = (s >= 0) & (z >= 0) & (z < nz)
                    a[ok, tz] = staged[s[ok], z[ok]]
                a = torch.cat([a.view(n_pad, 3 * cp),
                               a.new_zeros(n_pad, m_pad - 3 * cp)], 1)
                for st in range(n_pad // 16):
                    a16 = a[16 * st:16 * st + 16].t().reshape(-1, 16, 16)
                    b16 = b[16 * st:16 * st + 16].reshape(16, -1, 8)
                    # tile (mt, nt): (16 x 16) of A_k^T by (16 x 8) of B
                    acc[k] += torch.einsum('mik,knj->minj', a16,
                                           b16).reshape(m_pad, np_)
        parts.append(acc[:, :3 * cp].reshape(9, 3, cp, np_)
                     [:, :, :cin, :cout].reshape(27, cin, cout))
    out = torch.zeros(27, cin, cout)
    for part in parts:                    # block order
        out = out + part
    return out


def _walk(feats, nbr, found, g, nz, tv=16, n_blocks=3):
    cin, cout = feats.shape[1] // nz, g.shape[1] // nz
    rows, cp, g_rows, np_ = WF.wgrad_rows(feats, g, nz)
    src = torch.where(found, nbr, -1)
    return _kernel_walk(rows, cp, src, g_rows, np_, nz, cin, cout, tv,
                        n_blocks)


def _assert_close(got, want):
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, want.float(), rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize('nz', [41, 21, 25])
@pytest.mark.parametrize('cin,cout', [(5, 16), (16, 16), (32, 32), (12, 7)])
def test_walk_matches_plain(cin, cout, nz):
    n_cols = 45                           # 3 chunks of 16, the last ragged
    feats, nbr, found, g = _inputs(cin, cout, nz, n_cols, seed=cin + nz)
    got = _walk(feats, nbr, found, g, nz)
    _assert_close(got, WF.subm_conv_wgrad_plain(feats, nbr, found, g, nz))


@pytest.mark.parametrize('cin,cout', [(5, 16), (32, 32), (12, 7)])
def test_wgrad_rows_pitch(cin, cout):
    """Cin and Cout at their pitches (8, 16 or 32), channels past them
    zero; rows already at a pitch are the rows themselves."""
    nz = 9
    feats, _, _, g = _inputs(cin, cout, nz, 4, seed=cin)
    rows, cp, g_rows, np_ = WF.wgrad_rows(feats, g, nz)
    assert (cp, np_) == (WF.channel_pitch(cin), WF.channel_pitch(cout))
    for x, p, c in ((rows, cp, cin), (g_rows, np_, cout)):
        src = feats if x is rows else g
        assert x.shape == (src.shape[0], nz * p)
        view = x.view(-1, nz, p)
        assert torch.equal(view[..., :c], src.view(-1, nz, c))
        assert not view[..., c:].any()
        assert x.data_ptr() % 16 == 0
        if c == p:
            assert x.data_ptr() == src.data_ptr()   # no copy


def test_only_the_listed_items_rows_are_read():
    """A listed item (c, zo) of a found tap reads its source's z rows
    zo - 1 .. zo + 1 and nothing else: NaN in every other z row of every
    source row leaves the walk unchanged (taps not taken, z rows outside
    the column and pad items read the zero row)."""
    nz, cin, cout, n_cols = 21, 32, 32, 20
    feats, nbr, found, g = _inputs(cin, cout, nz, n_cols, seed=5,
                                   density=0.05)
    want = WF.subm_conv_wgrad_plain(feats, nbr, found, g, nz)
    act = g.view(n_cols, nz, cout).ne(0).any(-1)
    read = torch.zeros(feats.shape[0], nz, dtype=torch.bool)
    for k in range(9):
        for c, zo in torch.nonzero(act & found[k][:, None]).tolist():
            read[int(nbr[k, c]), max(zo - 1, 0):zo + 2] = True
    poisoned = feats.clone().view(-1, nz, cin)
    poisoned[~read] = float('nan')
    assert int((~read).sum()) > read.numel() // 2
    _assert_close(_walk(poisoned.view(-1, nz * cin), nbr, found, g, nz),
                  want)


def test_all_zero_cotangent_lists_nothing():
    """A cotangent of zeros, -0 among them (a negative value times the
    mask's zero): no row is listed (the kernel flags values, not bits)."""
    nz, cin, cout = 21, 16, 16
    feats, nbr, found, _ = _inputs(cin, cout, nz, 30, seed=8)
    g = torch.zeros(30, nz * cout)
    g[::2] = -0.0
    assert torch.signbit(g).any()
    got = _walk(feats, nbr, found, g, nz)
    assert torch.equal(got, torch.zeros(27, cin, cout))
    assert torch.equal(WF.subm_conv_wgrad_plain(feats, nbr, found, g, nz),
                       torch.zeros(27, cin, cout))


@pytest.mark.parametrize('tv,n_blocks', [(64, 1), (7, 4), (1, 5)])
def test_ragged_chunks_and_block_order(tv, n_blocks):
    """Chunks that do not divide the columns, and more blocks than some
    get chunks: the same sums."""
    nz, cin, cout, n_cols = 25, 16, 16, 71
    assert n_cols % tv or tv == 1
    feats, nbr, found, g = _inputs(cin, cout, nz, n_cols, seed=tv)
    got = _walk(feats, nbr, found, g, nz, tv=tv, n_blocks=n_blocks)
    _assert_close(got, WF.subm_conv_wgrad_plain(feats, nbr, found, g, nz))


def test_dropped_taps_enter_the_gradient():
    """A window plan that drops taps: the backward's full found keeps them
    (the JAX _winfuse_bwd), and the walk over it is the plain version's,
    not the kept taps' gradient."""
    nz, cin, cout, n_cols = 21, 32, 32, 96
    feats, nbr, full, g = _inputs(cin, cout, nz, n_cols, seed=13,
                                  density=0.3)
    kept, n_dropped = WF.fused_found(SC.ColumnMap(nbr, full), block=16,
                                     window=24, resid_blocks=1)
    assert int(n_dropped) > 0 and not torch.equal(kept, full)
    got = _walk(feats, nbr, full, g, nz)
    want = WF.subm_conv_wgrad_plain(feats, nbr, full, g, nz)
    _assert_close(got, want)
    kept_only = WF.subm_conv_wgrad_plain(feats, nbr, kept, g, nz)
    assert float((kept_only - want).abs().max()) > \
        1e-3 * float(want.abs().max())


def test_wrapper_raises_on_shapes_the_kernel_does_not_take():
    nz = 5
    # past the kernels' 128 channels (33 to 128 take the wide kernels)
    feats = torch.zeros(4, nz * 129, dtype=torch.bfloat16)
    g = torch.zeros(4, nz * 16, dtype=torch.bfloat16)
    nbr = torch.zeros(9, 4, dtype=torch.int32)
    found = torch.ones(9, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match='channels'):
        WF._wgrad_cuda(feats, nbr, found, g, nz)
    with pytest.raises(ValueError, match='cotangent'):
        WF._wgrad_cuda(torch.zeros(4, nz * 16, dtype=torch.bfloat16), nbr,
                       found, g.float(), nz)


def test_walk_matches_jax_vjp():
    """The walk against the JAX package's d weights (jax.vjp of the
    interpret-mode kernel's custom VJP, fp32 at 'highest'), bf16-exact
    inputs and a cotangent zero at the inactive sites."""
    jcs, pcs = _columns(11, 256, column_heavy=True)
    nz = SHAPE[2]
    rng = np.random.default_rng(12)
    feats = _bf16_exact(np.asarray(jcs.feats))
    cin, cout = feats.shape[1] // nz, 12
    w = (rng.normal(size=(27, cin, cout)) * 0.3).astype(np.float32)
    zmask = np.asarray(jcs.zmask, np.float32).reshape(256, nz, 1)
    g = _bf16_exact((rng.normal(size=(256, nz, cout)) * zmask).reshape(
        256, nz * cout))
    jm = JSC.build_column_map(jcs, SHAPE[:2])
    plan = JWF.build_fused_plan(jm, jcs.col_mask, block=16, window=64,
                                resid_blocks=4)
    with jax.default_matmul_precision('highest'):
        _, vjp = jax.vjp(lambda f, ww: JWF.subm_conv_winfuse(
            f, jcs.zmask, jm, plan, ww, mask_output=False, window=64,
            interpret=True), jnp.asarray(feats.numpy()), jnp.asarray(w))
        want = np.asarray(vjp(jnp.asarray(g.numpy()))[1])
    pm = SC.build_column_map(pcs, SHAPE[:2])
    assert 0 < int(g.ne(0).view(256, nz, cout).any(-1).sum()) < 256 * nz
    got = _walk(feats, pm.nbr, pm.found, g, nz, tv=64, n_blocks=2)
    _assert_close(got, torch.from_numpy(np.array(want)))
