"""Port's patch pool (streamingflow_tpu_torch/ops/patch_pool.py) vs the JAX
Pallas kernel in interpret mode, at C = 64 (the JAX kernel's only width).

Outputs agree at rtol/atol 1e-5 (fp32 sums of the same bf16-rounded rows in
another order, tests/test_patch_pool.py), and the per-frame drop counts are
equal: the port keeps the JAX kernel's patch budget and drops the same rows.
The CUDA kernel is held against the plain version on the card by
chip_smoke.py.

The pool's gradient (a ``torch.autograd.Function``; its plain version here)
is held against ``jax.vjp`` of the interpret-mode pool at 1e-5, with exactly
zero gradient for a row the patch budget dropped, and against ordinary
autograd through the plain version of the forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamingflow_tpu import geometry as G
from streamingflow_tpu.ops import lift_splat as LS
from streamingflow_tpu.ops.pallas_patch_pool import patch_pool_frames as jpool
from streamingflow_tpu_torch.ops import patch_pool as PP

from torch_parity import t

NX = NY = 48
RES = np.array([0.5, 0.5, 20.0], np.float32)
START = np.array([-11.75, -11.75, 0.0], np.float32)


def _camera_like(seed=0, n_cam=2, d=6, fh=4, fw=8, frames=1):
    """Frustum features + quantized coords from plausible pinhole cameras
    (the per-4-column angle of the flagship setup, as in
    tests/test_patch_pool.py)."""
    rng = np.random.RandomState(seed)
    frustum = G.create_frustum((fh * 8, fw * 8), 8, (2.0, 2.0 + d, 1.0))
    intr = np.array([[[380.0, 0, fw * 4], [0, 380.0, fh * 4], [0, 0, 1]]]
                    * n_cam, np.float32)
    extr = []
    for i in range(n_cam):
        yaw = 2 * np.pi * i / n_cam + 0.2 + 0.1 * seed
        c, s = np.cos(yaw), np.sin(yaw)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = np.array([[c, 0, s], [s, 0, -c], [0, -1, 0]], np.float32)
        E[:3, 3] = [0.5 * c, 0.5 * s, 1.5]
        extr.append(E)
    geom = G.get_geometry(jnp.asarray(frustum), jnp.asarray(intr)[None],
                          jnp.asarray(np.stack(extr))[None])[0]
    coords = np.asarray(LS.quantize_geometry(geom, START, RES))
    kept = ((coords[..., 0] >= 0) & (coords[..., 0] < NX)
            & (coords[..., 1] >= 0) & (coords[..., 1] < NY)
            & (coords[..., 2] >= 0) & (coords[..., 2] < 1))
    x = rng.randn(frames, n_cam, d, fh, fw, 64).astype(np.float32)
    coords = np.broadcast_to(coords[None, ..., :2],
                             (frames,) + coords.shape[:-1] + (2,))
    kept = np.broadcast_to(kept[None], (frames,) + kept.shape)
    return x, np.ascontiguousarray(coords), np.ascontiguousarray(kept)


def _both(x, coords, kept):
    want, want_drops = jpool(jnp.asarray(x), jnp.asarray(coords),
                             jnp.asarray(kept), NX, NY, interpret=True)
    got, drops = PP.patch_pool_frames(t(x), t(coords), t(kept), NX, NY)
    return got, drops, np.asarray(want), np.asarray(want_drops)


def _check(got, drops, want, want_drops):
    np.testing.assert_array_equal(drops.numpy(), want_drops.astype(np.int64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('seed,fw', [(0, 8), (1, 12), (2, 16)])
def test_matches_pallas_on_camera_geometry(seed, fw):
    x, coords, kept = _camera_like(seed, fw=fw, frames=2)
    got, drops, want, want_drops = _both(x, coords, kept)
    assert int(drops.sum()) == 0
    _check(got, drops, want, want_drops)


@pytest.mark.parametrize('fw', [7, 10])
def test_ragged_width_matches_scatter(fw):
    """fW not a multiple of 4: the last group of each row is padded with
    invalid rows.  The JAX packing rejects such widths (its pad spec has one
    axis too many), so the port is held against the JAX 'scatter' pool of
    the same bf16-rounded rows, which it equals when nothing drops."""
    x, coords, kept = _camera_like(seed=5, fw=fw)
    got, drops = PP.patch_pool_frames(t(x), t(coords), t(kept), NX, NY)
    assert int(drops.sum()) == 0
    xq = jnp.asarray(x[0]).astype(jnp.bfloat16).astype(jnp.float32)
    cells = np.concatenate([coords[0], np.zeros_like(coords[0][..., :1])],
                           -1)
    geom = (cells.astype(np.float32) + 0.5) * RES + (START - RES / 2)
    geom = np.where(kept[0][..., None], geom, -1e4).astype(np.float32)
    want = LS.bev_pool(xq.reshape(-1, 64), jnp.asarray(geom).reshape(-1, 3),
                       START, RES, (NX, NY, 1))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_budget_violation_counted_like_pallas():
    """Random cells spread past the 16 x 24 patch: the same rows drop, and
    the counts agree frame by frame."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 1, 1, 4, 8, 64).astype(np.float32)
    coords = rng.randint(0, NX, (2, 1, 1, 4, 8, 2)).astype(np.int32)
    kept = rng.rand(2, 1, 1, 4, 8) > 0.2
    got, drops, want, want_drops = _both(x, coords, kept)
    assert (drops > 0).all()
    _check(got, drops, want, want_drops)


def test_boundary_clamp_keeps_edge_cells():
    x = np.ones((1, 1, 1, 4, 8, 64), np.float32)
    coords = np.zeros((1, 1, 1, 4, 8, 2), np.int32)
    coords[..., 0] = NX - 1
    coords[..., 1] = NY - 1
    kept = np.ones((1, 1, 1, 4, 8), bool)
    got, drops, want, want_drops = _both(x, coords, kept)
    _check(got, drops, want, want_drops)
    assert int(drops[0]) == 0 and float(got[0, NX - 1, NY - 1, 0]) == 32.0


def test_all_rows_out_of_range():
    x, coords, kept = _camera_like(seed=1)
    kept = np.zeros_like(kept)
    got, drops, want, want_drops = _both(x, coords + 1000, kept)
    _check(got, drops, want, want_drops)
    assert not got.numpy().any()


def test_plain_takes_narrower_features():
    """The plain version takes any C <= 64: at C = 16 it equals the first
    16 channels of the C = 64 pool."""
    x, coords, kept = _camera_like(seed=4)
    full, d_full = PP.patch_pool_frames(t(x), t(coords), t(kept), NX, NY)
    part, d_part = PP.patch_pool_frames(t(x[..., :16]), t(coords), t(kept),
                                        NX, NY)
    np.testing.assert_array_equal(d_full.numpy(), d_part.numpy())
    np.testing.assert_array_equal(part.numpy(), full[..., :16].numpy())


def test_kernel_wrapper_rejects_other_widths():
    """The CUDA path takes C = 64 only and says so before any launch."""
    x = torch.zeros(1, 1, 1, 4, 8, 16)
    with pytest.raises(ValueError, match='64'):
        PP._patch_pool_cuda(x, torch.zeros(1, 1, 1, 4, 8, 2,
                                           dtype=torch.int32),
                            torch.ones(1, 1, 1, 4, 8, dtype=torch.bool),
                            NX, NY)


def _grads(x, coords, kept, seed=0):
    """(Function's gradient, plain version's autograd gradient, jax.vjp's
    gradient, fits mask) for one random output cotangent."""
    dout = np.random.RandomState(seed).randn(
        x.shape[0], NX, NY, 64).astype(np.float32)
    (_, _), vjp = jax.vjp(
        lambda v: jpool(v, jnp.asarray(coords), jnp.asarray(kept), NX, NY,
                        interpret=True), jnp.asarray(x))
    want = np.asarray(vjp((jnp.asarray(dout),
                           jnp.zeros(x.shape[0], jnp.float32)))[0])
    grads = []
    for pool in (PP.patch_pool_frames, PP.patch_pool_frames_plain):
        xt = t(x).requires_grad_()
        out, drops = pool(xt, t(coords), t(kept), NX, NY)
        assert not drops.requires_grad
        out.backward(t(dout))
        grads.append(xt.grad)
    fits = PP.fits_mask(t(coords), t(kept), NX, NY)[1].numpy()
    return grads[0], grads[1], want, fits


@pytest.mark.parametrize('seed,fw', [(0, 8), (2, 16)])
def test_gradient_matches_jax_vjp_on_camera_geometry(seed, fw):
    x, coords, kept = _camera_like(seed, fw=fw, frames=2)
    got, plain, want, fits = _grads(x, coords, kept, seed)
    assert got.dtype == torch.float32 and fits.any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a gather in both: the same values, not only close ones
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    assert not got.numpy()[~fits].any()


def test_gradient_is_exactly_zero_for_dropped_rows():
    """The forced overflow of test_budget_violation_counted_like_pallas:
    kept rows outside the patch get no gradient, as in jax.vjp; the rows
    that were summed get their cell's cotangent."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 1, 1, 4, 8, 64).astype(np.float32)
    coords = rng.randint(0, NX, (2, 1, 1, 4, 8, 2)).astype(np.int32)
    kept = rng.rand(2, 1, 1, 4, 8) > 0.2
    got, plain, want, fits = _grads(x, coords, kept)
    dropped = kept & ~fits
    assert dropped.any() and fits.any()
    assert not got.numpy()[dropped].any() and not want[dropped].any()
    assert not got.numpy()[~kept].any()
    assert np.abs(got.numpy()[fits]).min() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_gradient_comes_back_in_the_input_dtype_unrounded():
    """The forward rounds x to bf16, the backward does not: an fp32 x gets
    the fp32 cotangent, a bf16 x a bf16 gradient."""
    x, coords, kept = _camera_like(seed=1)
    dout = torch.full((1, NX, NY, 64), 1.0 + 2.0 ** -12)
    for dtype in (torch.float32, torch.bfloat16):
        xt = t(x).to(dtype).requires_grad_()
        PP.patch_pool_frames(xt, t(coords), t(kept), NX, NY)[0].backward(dout)
        assert xt.grad.dtype == dtype
        kept_vals = xt.grad[PP.fits_mask(t(coords), t(kept), NX, NY)[1]]
        want = dout.flatten()[0].to(dtype)
        assert (kept_vals == want).all()


def test_backward_wrapper_takes_plain_version_only_for_cpu_tensors(
        monkeypatch):
    monkeypatch.setattr(PP, 'launches_bwd', 0)
    x, coords, kept = _camera_like(seed=1)
    got = PP.patch_pool_grad(torch.ones(1, NX, NY, 64), t(coords), t(kept),
                             NX, NY, torch.float32)
    assert PP.launches_bwd == 0 and tuple(got.shape) == x.shape
    with pytest.raises(ValueError, match='cotangent'):
        PP._patch_pool_grad_cuda(torch.ones(1, NX, NY, 16), t(coords),
                                 t(kept), NX, NY, torch.float32)
