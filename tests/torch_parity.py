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

from streamingflow_tpu_torch.convert import load_flax_variables, state_to_flax
from streamingflow_tpu_torch.ops.winfuse import tf32_rna

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


def init_jax(module, *args, seed=0, like=None, **kwargs):
    """Random variables for a flax module at these inputs (shapes from
    ``eval_shape``: nothing is compiled).  Only 'params' and 'batch_stats'
    are kept: a collection that a module sows into (the LiDAR encoder's
    'diagnostics') is output, not weights.

    ``like``: the port's counterpart of ``module``, whose variable tree
    (``state_to_flax``, keys sorted as JAX's tree order sorts them) gives
    the same shapes, and so the same draws, without tracing the JAX
    module's init (seconds for an encoder or a whole model)."""
    if like is not None:
        return random_variables(port_shapes(like), seed)
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda *a: module.init(
        {'params': key, 'dropout': key, 'sample': key}, *a, **kwargs), *args)
    return random_variables({c: shapes[c] for c in ('params', 'batch_stats')
                             if c in shapes}, seed)


def port_like(cfg, train=False):
    """The port's counterpart, on the CPU, of the JAX package's
    StreamingFlow at its config ``cfg`` (``train``: of its train module):
    the template ``init_jax``'s ``like`` takes."""
    from streamingflow_tpu_torch.config import Config
    from streamingflow_tpu_torch.models.streamingflow import StreamingFlow
    from streamingflow_tpu_torch.training.trainer import (
        StreamingFlowTrainModule)
    pcfg = Config().merge_dict(cfg.to_dict())
    return (StreamingFlowTrainModule if train else StreamingFlow)(pcfg)


# submodules of the port's tree that the JAX module's init never creates:
# the distribution head (JAX creates it only when a forward calls it)
NOT_IN_JAX_INIT = ('present_distribution',)


def port_shapes(module):
    """The flax variable tree of a port module (nested, arrays with the
    leaves' shapes), each level's keys sorted, without NOT_IN_JAX_INIT:
    'params', and 'batch_stats' where it has any."""
    def nest(flat):
        tree = {}
        for path, leaf in flat.items():
            *parents, name = path.split('/')
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = leaf
        return tree

    def ordered(tree):
        return {k: ordered(v) if isinstance(v, dict) else v
                for k, v in sorted(tree.items()) if k not in NOT_IN_JAX_INIT}
    flat = state_to_flax(module)
    return {c: ordered(nest(flat[c])) for c in ('params', 'batch_stats')
            if flat.get(c)}


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


def tf32_split(x):
    """The 3xTF32 kernels' split of fp32 x: (hi, lo), hi its TF32 rounding
    and lo the rest rounded the same way."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma3(acc, a, b):
    """acc += a @ b as K3's 3xTF32 kernels' three mma a k8 step do it (fp32
    accumulators, the small terms first); b may come split, as (hi, lo)."""
    ah, al = tf32_split(a)
    bh, bl = b if isinstance(b, tuple) else tf32_split(b)
    acc += al @ bh
    acc += ah @ bl
    acc += ah @ bh
    return acc


def fp32_column_inputs(cin, cout, nz, n_cols, seed, density=0.3):
    """K3's inputs in fp32 for the kernel walks: rows zero at inactive
    sites, as on the main path; a source row read by one column a tap at
    most; a column with no tap and a tap no column has; a cotangent zero
    (-0, as the masked one) at inactive output sites.  (feats (R, nz*Cin),
    nbr (9, V) int32, found (9, V) bool, w (27, Cin, Cout), g (V,
    nz*Cout))."""
    rng = np.random.default_rng(seed)
    rows = n_cols + 5
    act = rng.random((rows, nz)) < density
    act[:, 0] = act[:, -1] = True         # real values next to the z edges
    feats = rng.standard_normal((rows, nz, cin)).astype(np.float32) * \
        act[..., None]
    nbr = np.stack([rng.permutation(rows)[:n_cols] for _ in range(9)])
    found = rng.random((9, n_cols)) < 0.7
    found[:, 3] = False
    found[4, :] = False
    w = rng.standard_normal((27, cin, cout)).astype(np.float32) * \
        (27 * cin) ** -0.5
    g = rng.standard_normal((n_cols, nz, cout)).astype(np.float32) * \
        (rng.random((n_cols, nz, 1)) < density)
    g[g == 0] = -0.0                      # the masked cotangent's -0
    return (torch.from_numpy(feats.reshape(rows, -1)),
            torch.from_numpy(nbr).int(), torch.from_numpy(found),
            torch.from_numpy(w), torch.from_numpy(g.reshape(n_cols, -1)))
