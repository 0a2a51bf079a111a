"""Helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same numpy inputs go through a JAX module of ``streamingflow_tpu`` (on
the CPU, matmuls at full fp32 precision) and its counterpart in
``streamingflow_tpu_torch`` (on the CPU, so every kernel wrapper takes its
plain PyTorch version), with the JAX weights carried across by the port's
bridge (streamingflow_tpu_torch/convert.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from streamingflow_tpu_torch.convert import load_flax_variables

# the suite runs in several worker processes at once: two intra-op threads
# each keep them from contending for the cores
torch.set_num_threads(2)


def random_variables(shapes, seed=0):
    """Numpy variables of the given flax shape tree, drawn at random:
    kernels N(0, 1/fan_in), BN/LN statistics, scales and biases around
    their flax initial values (constants there would hide a mixed-up
    channel or a missed statistic)."""
    rng = np.random.RandomState(seed)

    def draw(col, name, shape):
        if col == 'batch_stats' and name == 'var':
            return 0.5 + rng.rand(*shape)
        if col == 'batch_stats' or name.endswith('bias'):
            return 0.1 * rng.randn(*shape)
        if name in ('scale', 'gamma'):
            return 1.0 + 0.1 * rng.randn(*shape)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return rng.randn(*shape) / np.sqrt(fan_in)

    def walk(tree, col, name=''):
        if hasattr(tree, 'items'):
            return {k: walk(v, col, k) for k, v in tree.items()}
        return draw(col, name, tuple(tree.shape)).astype(np.float32)
    return {col: walk(tree, col) for col, tree in shapes.items()}


def init_jax(module, *args, seed=0, **kwargs):
    """Random variables for a flax module at these inputs (shapes from
    ``eval_shape``: nothing is compiled).  Only 'params' and 'batch_stats'
    are kept: a collection that a module sows into (the LiDAR encoder's
    'diagnostics') is output, not weights."""
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda *a: module.init(
        {'params': key, 'dropout': key, 'sample': key}, *a, **kwargs), *args)
    return random_variables({c: shapes[c] for c in ('params', 'batch_stats')
                             if c in shapes}, seed)


def apply_jax(module, variables, *args, **kwargs):
    with jax.default_matmul_precision('highest'):
        out = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
            variables, *args)
    return jax.tree.map(np.asarray, out)


def port(module, variables):
    """Load JAX variables into a torch module, eval mode."""
    return load_flax_variables(module, variables).eval()


def t(a, dtype=None):
    """numpy / JAX array -> CPU tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def nchw(a):
    """(B, H, W, C) array -> (B, C, H, W) tensor."""
    return t(a).permute(0, 3, 1, 2).contiguous()


def seq(a):
    """(B, T, H, W, C) array -> (B, T, C, H, W) tensor."""
    return t(a).permute(0, 1, 4, 2, 3).contiguous()


def nhwc(x):
    """(..., C, H, W) tensor -> (..., H, W, C) numpy."""
    return x.detach().movedim(-3, -1).numpy()


def assert_close(got, want, tol, what=''):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, scale), (
        f'{what}: max abs err {err:.3g} over max |want| {scale:.3g} '
        f'exceeds {tol:g}')


def jnp_tree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}
