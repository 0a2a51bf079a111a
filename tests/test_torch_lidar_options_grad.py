"""Parameter gradients of the spconv8x encoder's 'gather' engine, of
DENSE_TAIL_FROM_STAGE 0 ('winfuse': K3 at 64 and 128 channels, its custom
VJP on the JAX side) and of 'win' with taps dropped (no custom VJP on the
JAX side: a dropped tap gets no gradient) against ``jax.vjp`` on the CPU,
in train mode (the step's), at the micro size with caps the micro clouds
do not fill.

Bar: 1e-5 of each leaf's scale (tests/test_torch_winfuse_grad.py's); the
output and the updated statistics as tests/test_torch_lidar_options.py
holds them.  (In eval mode the JAX package's own fp32 gradient lies
further from its fp64 one at this size than the port's fp32 gradient does:
``test_eval_gradients_match_jax_with_fp64_variables`` prints both
distances; ROADMAP Queue 3.)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from streamingflow_tpu.models import lidar_encoder as JL
from streamingflow_tpu_torch.convert import flatten, state_to_flax
from streamingflow_tpu_torch.models import lidar_encoder as PL

from test_torch_lidar import _port_se
from test_torch_lidar_options import micro, points
from torch_parity import assert_close, init_jax, port, t


# 'win' with a window too short for its blocks and one residual block
WIN_DROPS = dict(WINDOW_WIDTH=4, WINDOW_RESID_BLOCKS=1)


@pytest.mark.parametrize('engine,formulation,tail', [
    ('gather', 'sep', 3), ('column', 'winfuse', 0), ('column', 'win', 3)])
def test_train_gradients_match_jax(engine, formulation, tail):
    cfg = micro(engine, formulation, tail,
                **(WIN_DROPS if formulation == 'win' else {}))
    # remat changes no value: off on the JAX side (a shorter compile), on
    # on the port's where it applies
    cfg.REMAT_LADDER = False
    pts = points()
    module = JL.LidarBEVEncoder(cfg)
    variables = init_jax(module, jnp.asarray(pts))
    out_shape = jax.eval_shape(lambda v: module.apply(v, jnp.asarray(pts)),
                               variables).shape
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

    se = _port_se(cfg)
    se.REMAT_LADDER = True
    enc = port(PL.LidarBEVEncoder(se), variables).train()
    got = enc(t(pts))
    (got.permute(0, 1, 3, 4, 2) * t(cot)).sum().backward()
    if formulation == 'win':
        assert int(enc.last_n_dropped['stage1'].sum()) > 0
    assert_close(got.permute(0, 1, 3, 4, 2), np.asarray(out), 1e-4, 'output')
    stats = state_to_flax(enc)['batch_stats']
    for k, w in flatten(upd['batch_stats']).items():
        assert_close(stats[k], w, 1e-5, f'batch_stats {k}')
    want = flatten(grads)
    got_grads = state_to_flax(enc, grads=True)['params']
    assert set(got_grads) == set(want)
    for k, w in want.items():
        assert float(np.abs(w).max()) > 0, k
        assert_close(got_grads[k] / np.abs(w).max(), w / np.abs(w).max(),
                     1e-5, f'd {k}')


def test_eval_gradients_match_jax_with_fp64_variables():
    """Eval mode ('gather'): the port's fp32 parameter gradients within
    1e-5 of each leaf's scale of the JAX encoder's with fp64 variables (the
    points, and so the voxels, stay fp32 on both sides).  The distance of
    the JAX encoder's own fp32 gradients is printed beside the port's, for
    information (ROADMAP Queue 3)."""
    cfg = micro('gather')
    pts = points()
    module = JL.LidarBEVEncoder(cfg)
    variables = init_jax(module, jnp.asarray(pts))
    out_shape = jax.eval_shape(lambda v: module.apply(v, jnp.asarray(pts)),
                               variables).shape
    cot = np.random.default_rng(1).normal(size=out_shape)

    def jax_grads(x64):
        with jax.enable_x64(x64), jax.default_matmul_precision('highest'):
            dt = jnp.float64 if x64 else jnp.float32
            v = jax.tree.map(lambda a: jnp.asarray(a, dt), variables)

            def loss(params):
                out = module.apply({'params': params,
                                    'batch_stats': v['batch_stats']},
                                   jnp.asarray(pts))
                return jnp.sum(out * jnp.asarray(cot, out.dtype))
            return {k: np.asarray(g, np.float64) for k, g in
                    flatten(jax.jit(jax.grad(loss))(v['params'])).items()}

    want, jax32 = jax_grads(True), jax_grads(False)
    enc = port(PL.LidarBEVEncoder(_port_se(cfg)), variables)
    out = enc(t(pts))
    (out.permute(0, 1, 3, 4, 2) * t(cot).float()).sum().backward()
    got = state_to_flax(enc, grads=True)['params']

    def worst(grads):
        return max(float(np.abs(grads[k] - w).max() / np.abs(w).max())
                   for k, w in want.items())
    print(f'eval gradients from the fp64 JAX ones, of a leaf\'s scale: '
          f'port fp32 {worst(got):.3g}, JAX fp32 {worst(jax32):.3g}')
    assert worst(got) <= 1e-5
