"""The spconv8x backbone in train mode (streamingflow_tpu_torch/models/
lidar_encoder.py) against the JAX package's on the CPU: MaskedBatchNorm's
batch statistics in both layouts, the running statistics under a
rematerialised region, and the column-engine LidarBEVEncoder's train-mode
forward, its updated ``batch_stats``, its sown diagnostics and every
parameter gradient ('winfuse': the interpret-mode Pallas kernel and its
custom VJP on the JAX side, the port's K3 plain versions and WinfuseConv on
its side).

Bars: one BN 1e-5 of each output's scale in fp32 (the golden bar).  In
bf16 the output and d x to 2^-6 of their scale: the normalisation runs in
bf16 on both sides, which round its products in other places, a few bf16
steps apart.  d scale and d bias are the cotangents of the bf16 casts of
``inv`` and ``bias``, bf16 sums over the sites: XLA's CPU sum accumulates
them in bf16 and lands 1.2% / 1.6% of the scale from the exact sum here
(fused / dense), the port's (fp32 accumulation, one rounding) 0.1% / 0.3%;
so they are held to JAX at 2^-5 and d bias to the exact sum at 2^-8.  The
running statistics, summed in fp32 on both sides, to 1e-5.

The micro encoder: output and statistics to 1e-4 of their scale (the
encoder's eval bar), the gradient leaves to 1e-3 of the larger of the
leaf's scale and the median leaf scale (the ill-conditioned tiny batch: a
few values per channel under batch statistics), the diagnostics equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from streamingflow_tpu.models import lidar_encoder as JL
from streamingflow_tpu_torch.convert import flatten, state_to_flax
from streamingflow_tpu_torch.layers.trainmode import remat
from streamingflow_tpu_torch.models import lidar_encoder as PL

from test_torch_lidar import _micro_se, _port_se
from torch_parity import assert_close, init_jax, port, t


def _bn_inputs(layout, mask_case):
    rng = np.random.default_rng(0)
    c, nz = 6, 5
    if layout == 'fused':
        x = rng.normal(size=(2, 40, nz * c)) * 2 + 0.5
        mask = rng.random((2, 40, nz)) > 0.4
    else:
        x = rng.normal(size=(2, 4, 3, nz, c)) * 2 + 0.5
        mask = rng.random((2, 4, 3, nz)) > 0.4
    if mask_case == 'empty':
        mask[:] = False
    elif mask_case == 'one':
        mask[:] = False
        mask.reshape(-1)[7] = True
    return x.astype(np.float32), mask, c, rng


@pytest.mark.parametrize('mask_case', ['random', 'empty', 'one'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('layout', ['fused', 'dense'])
def test_masked_batch_norm_train_matches_jax(layout, dtype, mask_case):
    x, mask, c, rng = _bn_inputs(layout, mask_case)
    g = rng.normal(size=x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    module = JL.MaskedBatchNorm()
    variables = init_jax(module, jnp.asarray(x), jnp.asarray(mask))

    def run(xx, params):
        return module.apply({'params': params,
                             'batch_stats': variables['batch_stats']},
                            xx, jnp.asarray(mask), train=True,
                            mutable=['batch_stats'])
    want, stats = run(jnp.asarray(x, jdt), variables['params'])
    _, vjp = jax.vjp(lambda xx, p: run(xx, p)[0], jnp.asarray(x, jdt),
                     variables['params'])
    want_dx, want_dp = vjp(jnp.asarray(g, jdt))

    bn = port(PL.MaskedBatchNorm(c), variables).train()
    xt = t(x).to(getattr(torch, dtype))
    gt = t(g).to(xt.dtype)
    if layout == 'dense':             # the port's grids are channel first
        xt = xt.permute(0, 4, 1, 2, 3)
        gt = gt.permute(0, 4, 1, 2, 3)
    xt.requires_grad_()
    got = bn(xt, t(mask))
    got.backward(gt)
    dx = xt.grad
    if layout == 'dense':
        got, dx = got.permute(0, 2, 3, 4, 1), dx.permute(0, 2, 3, 4, 1)
    assert got.dtype == dx.dtype == xt.dtype
    bf16 = dtype == 'bfloat16'
    assert_close(got, want, 2 ** -6 if bf16 else 1e-5, 'output')
    assert_close(dx, want_dx, 2 ** -6 if bf16 else 1e-5, 'd x')
    for name, leaf in (('weight', 'scale'), ('bias', 'bias')):
        assert_close(getattr(bn, name).grad, want_dp[leaf],
                     2 ** -5 if bf16 else 1e-5, f'd {leaf}')
    # d bias is the sum of the cotangent (as the input's type holds it)
    # over the active sites
    g_in = t(g).to(xt.dtype).double().numpy().reshape(*mask.shape, c)
    exact = (g_in * mask[..., None]).reshape(-1, c).sum(0)
    assert_close(bn.bias.grad, exact, 2 ** -8 if bf16 else 1e-6, 'd bias')
    for name, leaf in (('running_mean', 'mean'), ('running_var', 'var')):
        assert_close(getattr(bn, name), stats['batch_stats'][leaf], 1e-5,
                     leaf)
        assert np.abs(np.asarray(stats['batch_stats'][leaf])
                      - variables['batch_stats'][leaf]).max() > 0
    if mask_case == 'empty':
        assert float(got.detach().abs().max()) == 0.0
        assert float(dx.abs().max()) == 0.0


def test_running_statistics_move_once_under_remat():
    """A rematerialised region runs the BN twice (the recompute in the
    backward); the running statistics move once, as without remat."""
    x, mask, c, _ = _bn_inputs('fused', 'random')
    stats = []
    for rematerialise in (False, True):
        torch.manual_seed(0)
        bn = PL.MaskedBatchNorm(c).train()
        xt = t(x).requires_grad_()
        out = (remat(bn, bn, None, xt, t(mask)) if rematerialise
               else bn(xt, t(mask)))
        out.square().sum().backward()
        stats.append((bn.running_mean.clone(), bn.running_var.clone(),
                      xt.grad))
    for a, b in zip(*stats):
        assert torch.equal(a, b)
    assert float(stats[0][0].abs().max()) > 0     # moved from zero


def _points():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-4, 4, size=(1, 2, 256, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-4, 3.5, size=(1, 2, 256))
    return pts


@pytest.fixture(scope='module')
def jax_micro_step():
    """The JAX micro encoder (tests/test_winfuse.py's config) in train
    mode: output, new batch_stats, diagnostics and the gradient of
    sum(out * cot), jitted once.  REMAT_LADDER off on the JAX side: remat
    does not change the function, and the compile takes 36 s in place of 53
    (the port's side runs with it on; test_remat_ladder_on_and_off_agree
    holds the port's remat)."""
    cfg = _micro_se()
    cfg.REMAT_LADDER = False
    pts = _points()
    module = JL.LidarBEVEncoder(cfg)
    enc = PL.LidarBEVEncoder(_port_se(cfg))
    variables = init_jax(module, like=enc)
    with torch.no_grad():     # the output's shape, (B, T, H, W, C)
        out_shape = port(enc, variables)(t(pts)).permute(0, 1, 3, 4, 2).shape
    cot = np.random.default_rng(1).normal(size=out_shape).astype(np.float32)

    def loss(params):
        out, upd = module.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(pts), train=True,
            mutable=['batch_stats', 'diagnostics'])
        return jnp.sum(out * cot), (out, upd)

    with jax.default_matmul_precision('highest'):
        (_, (out, upd)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables['params'])
    diag = {k: int(np.asarray(v).reshape(-1)[0]) for k, v in
            flatten(upd['diagnostics']).items()}
    return dict(cfg=cfg, pts=pts, variables=variables, cot=cot,
                out=np.asarray(out), grads=flatten(grads),
                stats=flatten(upd['batch_stats']),
                diag={k.split('/')[-1]: v for k, v in diag.items()})


def _port_micro_step(want, remat_ladder=True):
    se = _port_se(want['cfg'])
    se.REMAT_LADDER = remat_ladder
    enc = port(PL.LidarBEVEncoder(se), want['variables']).train()
    out = enc(t(want['pts']))
    (out.permute(0, 1, 3, 4, 2) * t(want['cot'])).sum().backward()
    return enc, out


def test_micro_encoder_train_step_matches_jax(jax_micro_step):
    want = jax_micro_step
    enc, out = _port_micro_step(want)
    assert_close(out.permute(0, 1, 3, 4, 2), want['out'], 1e-4, 'output')
    assert float(np.abs(want['out']).max()) > 1e-2
    got_diag = {k: int(v) for k, v in enc.last_diagnostics.items()}
    assert got_diag == want['diag']
    assert set(got_diag) == {
        'lidar_dropped_sites_entry', 'lidar_columns_stage1',
        'lidar_columns_stage2', 'lidar_column_cap_hit_stage2',
        'lidar_columns_stage3', 'lidar_column_cap_hit_stage3'}
    stats = state_to_flax(enc)['batch_stats']
    assert set(stats) == set(want['stats'])
    for k, w in want['stats'].items():
        assert_close(stats[k], w, 1e-4, f'batch_stats {k}')
        assert np.abs(w - flatten(want['variables']['batch_stats'])[k]
                      ).max() > 0, k
    grads = state_to_flax(enc, grads=True)['params']
    assert set(grads) == set(want['grads'])
    floor = float(np.median([np.abs(g).max()
                             for g in want['grads'].values()]))
    for k, w in want['grads'].items():
        err = float(np.abs(grads[k] - w).max())
        assert err <= 1e-3 * max(float(np.abs(w).max()), floor), (k, err)


def test_remat_ladder_on_and_off_agree(jax_micro_step):
    """Per-block checkpoints change nothing: the same output, gradients and
    statistics with SPARSE_ENCODER.REMAT_LADDER on and off."""
    runs = [_port_micro_step(jax_micro_step, flag) for flag in (True, False)]
    (a, out_a), (b, out_b) = runs
    assert torch.equal(out_a, out_b)
    sa, sb = state_to_flax(a), state_to_flax(b)
    for k in sa['batch_stats']:
        np.testing.assert_array_equal(sa['batch_stats'][k],
                                      sb['batch_stats'][k], err_msg=k)
    ga, gb = (state_to_flax(e, grads=True)['params'] for e in (a, b))
    for k in ga:
        np.testing.assert_allclose(ga[k], gb[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
