"""The gradient of K3, the port's submanifold column conv
(streamingflow_tpu_torch/ops/winfuse.py: ``WinfuseConv``, the reversed map,
``subm_conv_dgrad``, ``subm_conv_wgrad``), against the JAX package's on the
CPU.

The JAX side is ``jax.vjp`` of ``pallas_winfuse.subm_conv_winfuse`` with
the Pallas kernel in interpret mode; its custom VJP (``_winfuse_bwd``)
differentiates the 'sep' conv over the map's full ``found``.  So where the
window plan drops taps the forward keeps the drops and the backward does
not, which the port's model path (``lidar_encoder.column_geometry`` +
``subm``) must follow.

Bars: 1e-5 of the gradient's scale in fp32 (the JAX package's golden bar).
d feats is compared on the active column slots only: on the empty slots the
JAX 'sep' vjp passes the centre tap's cotangent through (nonzero for the
random cotangent here), while the port's centre tap is not found there and
gives 0; in the model the masked BN before every conv zeroes the
cotangent of those slots, so no parameter gradient depends on them.  Among
themselves the port's pieces agree to 1e-6 (fp32) and 1e-12 (fp64).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from streamingflow_tpu.ops import pallas_winfuse as JWF
from streamingflow_tpu.ops import sparse_columns as JSC
from streamingflow_tpu_torch.config import Config as PConfig
from streamingflow_tpu_torch.models import lidar_encoder as PL
from streamingflow_tpu_torch.ops import sparse_columns as SC
from streamingflow_tpu_torch.ops import winfuse as WF

from test_torch_sparse import SHAPE, _columns
from torch_parity import assert_close, t

NZ = SHAPE[2]


def _encoder_cfg(block, window, resid):
    se = PConfig().MODEL.SPARSE_ENCODER
    se.Z_FORMULATION = 'winfuse'
    se.WINDOW_BLOCK, se.WINFUSE_WINDOW, se.WINDOW_RESID_BLOCKS = \
        block, window, resid
    return se


def _stacked(seeds, dtype=torch.float32):
    """Clouds of ``_columns`` stacked as the model stacks them: features
    (N*256, nz*8), the map with each cloud's slots offset, the active
    slots."""
    feats, nbrs, founds, act = [], [], [], []
    for i, seed in enumerate(seeds):
        _, pcs = _columns(seed, 256, column_heavy=True)
        pm = SC.build_column_map(pcs, SHAPE[:2])
        feats.append(pcs.feats)
        nbrs.append(pm.nbr + i * 256)
        founds.append(pm.found)
        act.append(pcs.col_mask)
    return (torch.cat(feats).to(dtype), torch.cat(nbrs, 1).int(),
            torch.cat(founds, 1), torch.cat(act))


@pytest.mark.parametrize('block,window,resid', [
    (16, 64, 4),    # wide window: nothing dropped
    (16, 20, 1),    # tight window, one residual block: taps dropped
])
def test_gradient_matches_jax_vjp(block, window, resid):
    """The model's conv (column_geometry + subm): forward over the kept
    taps, gradient over every found tap, as the JAX custom VJP."""
    jcs, pcs = _columns(11, 256, column_heavy=True)
    rng = np.random.default_rng(12)
    w = (rng.normal(size=(27, 8, 12)) * 0.3).astype(np.float32)
    g = rng.normal(size=(256, NZ * 12)).astype(np.float32)
    jm = JSC.build_column_map(jcs, SHAPE[:2])
    plan = JWF.build_fused_plan(jm, jcs.col_mask, block=block, window=window,
                                resid_blocks=resid)

    def conv(feats, weights):
        return JWF.subm_conv_winfuse(feats, jcs.zmask, jm, plan, weights,
                                     mask_output=False, window=window,
                                     interpret=True)
    with jax.default_matmul_precision('highest'):
        want, vjp = jax.vjp(conv, jcs.feats, jnp.asarray(w))
        want_df, want_dw = vjp(jnp.asarray(g))

    cs = SC.stack_sets([pcs])
    geo = PL.column_geometry(cs, SHAPE[:2], _encoder_cfg(block, window, resid))
    assert int(geo.n_dropped.sum()) == int(plan.n_dropped)
    if resid == 1:
        assert int(geo.n_dropped.sum()) > 0
    feats = cs.feats.clone().requires_grad_()
    wt = t(w).requires_grad_()
    got = PL.subm(feats, cs.zmask, geo, wt)
    got.backward(t(g)[None])
    assert_close(got[0], want, 1e-5, 'forward')
    act = np.asarray(jcs.col_mask)
    assert_close(feats.grad[0][t(act)], np.asarray(want_df)[act], 1e-5,
                 'd feats')
    assert_close(wt.grad, want_dw, 1e-5, 'd weights')
    assert float(np.abs(np.asarray(want_dw)).max()) > 1.0


def test_reversed_map_gives_the_autograd_dgrad():
    """d feats as the forward conv over the reversed map with flipped,
    transposed weights, against autograd of the plain forward, two clouds
    stacked; the reverse of the map read back."""
    feats, nbr, found, _ = _stacked((21, 22), torch.float64)
    src_t = WF.reverse_map(nbr, found, feats.shape[0])
    # every found tap k of v that lands on u is tap 8 - k of u, and back
    k, v = torch.nonzero(found, as_tuple=True)
    assert torch.equal(src_t[8 - k, nbr[k, v].long()], v.int())
    assert int((src_t >= 0).sum()) == int(found.sum())
    rng = np.random.default_rng(3)
    w = t(rng.normal(size=(27, 8, 12)), torch.float64)
    g = t(rng.normal(size=(feats.shape[0], NZ * 12)))
    x = feats.clone().requires_grad_()
    WF.subm_conv_plain(x, nbr, found, w, NZ).backward(g)
    got = WF.subm_conv_dgrad(g, src_t, w, NZ)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert float(x.grad.abs().max()) > 1.0


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_wgrad_plain_matches_autograd(dtype, tol):
    """subm_conv_wgrad_plain against autograd of the plain forward, and the
    autograd Function's gradients against the same, two clouds stacked."""
    launches = (WF.launches, WF.launches_dgrad, WF.launches_wgrad)
    feats, nbr, found, _ = _stacked((21, 22), dtype)
    rng = np.random.default_rng(4)
    w = t(rng.normal(size=(27, 8, 12)), dtype).requires_grad_()
    g = t(rng.normal(size=(feats.shape[0], NZ * 12)), dtype)
    WF.subm_conv_plain(feats, nbr, found, w, NZ).backward(g)
    want = w.grad.clone()
    got = WF.subm_conv_wgrad_plain(feats, nbr, found, g, NZ)
    assert got.dtype == dtype
    assert_close(got, want.numpy(), tol, 'wgrad plain')
    w.grad = None
    x = feats.clone().requires_grad_()
    WF.subm_conv_winfuse(x, nbr, found, w, NZ).backward(g)
    assert_close(w.grad, want.numpy(), tol, 'WinfuseConv d weights')
    # the CPU takes the plain versions: no kernel counted
    assert launches == (WF.launches, WF.launches_dgrad, WF.launches_wgrad)


def test_bf16_weight_gradient_rule():
    """bf16 features: the port's d weights is the fp32 sum of the bf16
    values' products, unrounded.  The JAX vjp rounds each tap's partial sum
    of one (output z, input z) pair to bf16 (its band matrices are bf16)
    and sums them over z in fp32: it lies within 2^-8 of the sum of those
    partials' magnitudes of the exact value, and closer to the unrounded
    sum than to that sum rounded once to bf16."""
    jcs, pcs = _columns(11, 256, column_heavy=True)
    rng = np.random.default_rng(12)
    w = (rng.normal(size=(27, 8, 12)) * 0.3).astype(np.float32)
    g = jnp.asarray(rng.normal(size=(256, NZ * 12)), jnp.bfloat16)
    fb = jcs.feats.astype(jnp.bfloat16)
    jm = JSC.build_column_map(jcs, SHAPE[:2])
    plan = JWF.build_fused_plan(jm, jcs.col_mask, block=16, window=64,
                                resid_blocks=4)
    _, vjp = jax.vjp(lambda f, ww: JWF.subm_conv_winfuse(
        f, jcs.zmask, jm, plan, ww, mask_output=False, window=64,
        interpret=True), fb, jnp.asarray(w))
    want = np.asarray(vjp(g)[1])

    pm = SC.build_column_map(pcs, SHAPE[:2])
    pf = t(np.asarray(fb, np.float32)).to(torch.bfloat16)
    pg = t(np.asarray(g, np.float32)).to(torch.bfloat16)
    got = WF.subm_conv_wgrad_plain(pf, pm.nbr, pm.found, pg, NZ)
    assert got.dtype == torch.float32
    exact = WF.subm_conv_wgrad_plain(pf.double(), pm.nbr, pm.found,
                                     pg.double(), NZ)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-6,
                               atol=1e-5)
    # the magnitudes of the partials JAX rounds: per tap and output z
    f = SC.padded_rows(pf.double(), NZ, 1, NZ + 2)
    src = torch.where(pm.found, pm.nbr, 256).long()
    gv = pg.double().reshape(256, NZ, 12)
    mag = torch.stack([torch.einsum(
        'vzit,vzj->ztij', SC.z_windows(f.index_select(0, src[k]), NZ, 3, 1),
        gv).abs().sum(0) for k in range(9)]).reshape(27, 8, 12)
    err = np.abs(want - exact.numpy())
    assert (err <= 2 ** -8 * mag.numpy() + 1e-4).all()
    once = got.to(torch.bfloat16).float().numpy()
    assert np.abs(got.numpy() - want).max() < np.abs(once - want).max()
