"""A flax-named weight tree -> the reference (PyTorch) state dict it came
from, by inverting a checkpoint rule table kind by kind.

The inverse of utils/torch_convert.py::apply_mapping (the JAX package's and
the port's copy alike), for tests and the card's smoke test: neither
package has an exporter, so a reference-named state dict is made from a
flax tree.  Imports numpy only, and takes the rule list as an argument.

The leaves are walked from the last and each leaf's matching rules from the
last, and a leaf takes the last torch key still free.  Where the table lists
fall-through rules (EfficientNet's BatchNorm numbering, which shifts down
one in blocks without an expand conv), that gives the reference's own
names: ``_bn1``, ``_bn2`` in such a block, ``_bn0``..``_bn2`` elsewhere.
"""
import re

import numpy as np

BN_LEAVES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
             'var': 'running_var'}
# spconv kernels (kD, kH, kW) by their number of taps: mmdet3d's
# SparseEncoder uses 3x3x3 convs and a (3, 1, 1) conv_out
SPCONV_TAPS = {27: (3, 3, 3), 3: (3, 1, 1)}


def _order(paths):
    """The JAX package's flattening order: each level's keys sorted."""
    return sorted(paths, key=lambda p: p.split('/'))


def _invert(path, value, kind, tkey):
    """{torch key: array} of one rule for one leaf."""
    value = np.asarray(value)
    leaf = path.rsplit('/', 1)[-1]
    if kind == 'bn':
        return {f'{tkey}.{BN_LEAVES[leaf]}': value}
    if kind in ('conv_cat', 'raw_cat'):
        keys = tkey.split('|')
        parts = np.split(value, len(keys), axis=-1)
        if kind == 'conv_cat':
            parts = [np.transpose(p, (p.ndim - 1, p.ndim - 2,
                                      *range(p.ndim - 2))) for p in parts]
        return dict(zip(keys, parts))
    if kind == 'gru':
        raise NotImplementedError('gru rules (no table in the repo has one)')
    if path.endswith('kernel') and kind == 'conv':
        return {tkey: np.transpose(value, (value.ndim - 1, value.ndim - 2,
                                           *range(value.ndim - 2)))}
    if path.endswith('kernel') and kind == 'conv_transpose':
        nd = value.ndim
        w = np.flip(value, axis=tuple(range(nd - 2)))
        return {tkey: np.transpose(w, (nd - 2, nd - 1, *range(nd - 2)))}
    if path.endswith('kernel') and kind == 'linear':
        return {tkey: np.transpose(value)}
    if kind == 'spconv':
        taps = SPCONV_TAPS.get(value.shape[0], (value.shape[0],))
        return {tkey: value.reshape(*taps, *value.shape[1:])}
    return {tkey: value}


def reference_state_dict(flat, rules, bn_counters=True):
    """The reference state dict ({key: numpy array}, no ``model.``) that
    ``apply_mapping(flat, sd, rules)`` fills every mapped leaf of ``flat``
    from, bit for bit.  ``flat``: {'params/...': array, 'batch_stats/...':
    array}.  Leaves no rule matches get no key.  ``bn_counters``: give each
    BatchNorm its ``num_batches_tracked`` counter, as a real checkpoint
    does."""
    sd = {}
    for path in reversed(_order(flat)):
        for pattern, template, kind in reversed(rules):
            m = re.fullmatch(pattern, path)
            if not m:
                continue
            out = _invert(path, flat[path], kind, m.expand(template))
            if any(k in sd for k in out):
                continue
            sd.update(out)
            if kind == 'bn' and bn_counters:
                sd[f'{m.expand(template)}.num_batches_tracked'] = \
                    np.array(0, np.int64)
            break
    return sd
