"""The pool's rows as the redesigned forward kernel walks them, held against
the JAX Pallas kernel in interpret mode (rtol/atol 1e-5, drop counts
equal), and the CUDA wrapper's row preparation and argument checks.

The kernel walks each image column of a group down h and keeps a running
fp32 sum while the cell stays the same, adding it into the grid when the
cell changes; it reads fp32 rows as they are and rounds them to bf16
itself.  On the CPU the wrapper takes the plain version, so these cases pin
the function that chip_smoke.py then holds the kernel to on the card: rows
on bf16 rounding ties (the port's rounding of fp32 rows equals JAX's cast
in ``pack_frustum_rows``), every row of a group in one cell (the longest
runs), every row in a cell of its own (no run longer than a row), a run
that leaves its cell and comes back (two adds into one cell from one
column), and a ragged width.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu.ops.pallas_patch_pool import patch_pool_frames as jpool
from streamingflow_tpu_torch.ops import patch_pool as PP

NX = NY = 48


def _group_origins(n, d, wb):
    """(n, d, wb) group -> a patch origin of its own on the grid: 16 x 8
    tiles, so no two groups of a frame share a cell."""
    g = np.arange(n * d * wb).reshape(n, d, wb)
    per_row = NX // 16
    assert n * d * wb <= per_row * (NY // 8)
    return g % per_row * 16, g // per_row * 8


def _coords(shape, case, rng):
    """(F, N, D, fH, fW, 2) int32 cells for one layout of the rows of each
    group (column q = w % 4 of group w // 4, row h)."""
    f, n, d, fh, fw = shape
    wb = -(-fw // 4)
    gx, gy = _group_origins(n, d, wb)
    gx = gx[None, :, :, None, :, None]
    gy = gy[None, :, :, None, :, None]
    h = np.arange(fh).reshape(1, 1, 1, fh, 1, 1)
    q = np.arange(4).reshape(1, 1, 1, 1, 1, 4)
    full = (f, n, d, fh, wb, 4)
    if case == 'one_cell':
        cx, cy = gx + 0 * h, gy + 0 * q
    elif case in ('all_distinct', 'ragged_fw7'):
        cx, cy = gx + h % 16, gy + h // 16 * 4 + q
    elif case == 'leave_and_return':
        # down h each column goes A A B B A A ..., and column q's B is
        # column q + 1's A: a cell gets two adds from one column and more
        # from its neighbours
        cx = gx + 0 * h
        cy = gy + (q + (h // 2) % 2) % 4
    else:                                       # 'ties': anywhere in patch
        cx = gx + rng.randint(0, 16, full)
        cy = gy + rng.randint(0, 24 - 8, full)
    cx, cy = np.broadcast_to(cx, full), np.broadcast_to(cy, full)
    c = np.stack([cx, cy], -1).reshape(f, n, d, fh, wb * 4, 2)[..., :fw, :]
    return np.ascontiguousarray(c, np.int32)


def _tie_rows(shape, rng):
    """fp32 values +-(1 + m 2^-8) 2^e, m odd: exactly halfway between two
    bf16 neighbours, so only round-to-nearest-even gives JAX's bits."""
    m = rng.randint(0, 128, shape) * 2 + 1
    e = rng.randint(-3, 4, shape)
    sign = rng.randint(0, 2, shape) * 2 - 1
    return (sign * (1 + m * 2.0 ** -8) * 2.0 ** e).astype(np.float32)


CASES = {          # shape (F, N, D, fH, fW); every row kept unless noted
    'ties': (2, 2, 2, 8, 8),
    'one_cell': (2, 2, 2, 28, 8),
    'all_distinct': (2, 2, 2, 28, 8),
    'leave_and_return': (2, 1, 2, 12, 8),
    'ragged_fw7': (2, 2, 2, 5, 7),
}


def _inputs(case, dtype, seed=0):
    rng = np.random.RandomState(seed)
    shape = CASES[case]
    coords = _coords(shape, case, rng)
    kept = np.ones(shape, bool)
    if case == 'ragged_fw7':
        kept = rng.rand(*shape) > 0.2
    x = (_tie_rows(shape + (64,), rng) if case == 'ties'
         else rng.randn(*shape, 64).astype(np.float32))
    xt = torch.from_numpy(x).to(dtype)
    # JAX gets the same values: bf16 rows as their exact fp32 values
    return xt, xt.float().numpy(), coords, kept


def _jax_pool(x, coords, kept):
    """JAX's interpret-mode pool.  Its packing takes widths that are a
    multiple of 4 only, so a ragged width is padded with one absent column
    (not kept), which adds nothing and drops nothing."""
    pad = -x.shape[4] % 4
    if pad:
        x = np.pad(x, ((0, 0),) * 4 + ((0, pad), (0, 0)))
        coords = np.pad(coords, ((0, 0),) * 4 + ((0, pad), (0, 0)))
        kept = np.pad(kept, ((0, 0),) * 4 + ((0, pad),))
    out, drops = jpool(jnp.asarray(x), jnp.asarray(coords),
                       jnp.asarray(kept), NX, NY, interpret=True)
    return np.asarray(out), np.asarray(drops)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', list(CASES))
def test_rows_match_pallas(case, dtype):
    xt, xj, coords, kept = _inputs(case, dtype)
    got, drops = PP.patch_pool_frames(xt, torch.from_numpy(coords),
                                      torch.from_numpy(kept), NX, NY)
    want, want_drops = _jax_pool(xj, coords, kept)
    np.testing.assert_array_equal(drops.numpy(), want_drops.astype(np.int64))
    assert int(drops.sum()) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    summed = got.abs().sum(-1) > 0
    if case == 'one_cell':
        # one cell a group: 2 x 2 x 2 groups of 28 x 4 rows into 8 cells
        assert int(summed.sum()) == 8 * 2
    if case == 'all_distinct':
        # one row a cell: the sums are the rounded rows themselves
        assert int(summed.sum()) == xt[..., 0].numel()
        np.testing.assert_array_equal(
            np.sort(got.numpy()[summed.numpy()], axis=None),
            np.sort(xt.to(torch.bfloat16).float().numpy(), axis=None))


def test_fp32_ties_round_as_jax_casts():
    """The port's rounding of fp32 rows is JAX's cast, bit for bit, on
    values that sit exactly on ties (both signs)."""
    x = _tie_rows((4096,), np.random.RandomState(1))
    port = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    jax_ = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert (x < 0).any() and (x > 0).any() and (port != x).all()
    np.testing.assert_array_equal(port, jax_)


# ------------------------------------------------ the wrapper's preparation

def _args(shape=(1, 2, 3, 4, 8), width=64, dtype=torch.float32):
    x = torch.randn(*shape, width).to(dtype)
    coords = torch.zeros(*shape, 2, dtype=torch.int32)
    kept = torch.ones(shape, dtype=torch.bool)
    return x, coords, kept


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_rows_pass_fp32_and_bf16_without_a_copy(dtype):
    x, coords, kept = _args(dtype=dtype)
    rows = PP.kernel_rows(x, coords, kept)
    assert rows is x and rows.data_ptr() == x.data_ptr()


@pytest.mark.parametrize('dtype', [torch.float64, torch.float16])
def test_kernel_rows_cast_other_floats_once_to_bf16(dtype):
    x, coords, kept = _args(dtype=dtype)
    rows = PP.kernel_rows(x, coords, kept)
    assert rows.dtype == torch.bfloat16 and rows.is_contiguous()
    assert torch.equal(rows, x.to(torch.bfloat16))


@pytest.mark.parametrize('width', [16, 65])
def test_kernel_rows_reject_other_widths(width):
    with pytest.raises(ValueError, match='64'):
        PP.kernel_rows(*_args(width=width))


@pytest.mark.parametrize('dtype', [torch.int32, torch.uint8])
def test_kernel_rows_reject_integer_rows(dtype):
    x, coords, kept = _args()
    with pytest.raises(ValueError, match='floating'):
        PP.kernel_rows(x.to(dtype), coords, kept)


def test_kernel_rows_reject_more_than_128_rows_a_group():
    with pytest.raises(ValueError, match='128'):
        PP.kernel_rows(*_args(shape=(1, 1, 1, 33, 4)))


def test_kernel_rows_reject_non_contiguous_rows():
    x, coords, kept = _args()
    x = x.transpose(3, 4).contiguous().transpose(3, 4)
    with pytest.raises(ValueError, match='contiguous'):
        PP.kernel_rows(x, coords, kept)


def test_kernel_rows_reject_misaligned_rows():
    x, coords, kept = _args()
    flat = torch.zeros(x.numel() + 1)
    shifted = flat[1:].view(x.shape)       # contiguous, 4 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match='aligned'):
        PP.kernel_rows(shifted, coords, kept)


def test_kernel_rows_reject_other_coords_and_mask():
    x, coords, kept = _args()
    with pytest.raises(ValueError, match='coords'):
        PP.kernel_rows(x, coords.long(), kept)
    with pytest.raises(ValueError, match='kept'):
        PP.kernel_rows(x, coords, kept.to(torch.uint8))
