"""A reference (PyTorch Lightning) checkpoint -> the port's state_dict.

Port of streamingflow_tpu/utils/torch_convert.py.  The released
StreamingFlow weights are a Lightning ``.ckpt`` whose ``state_dict`` names
the reference's modules (``model.encoder.backbone._blocks.3._bn1.weight``);
the port's modules carry the JAX package's flax paths instead
(``model/encoder/backbone/block_3/BatchNorm_0/scale``).  A rule table
(tools/rules_prediction_lc_ode_variable.py) ties the two namings together:
a list of ``(flax_path_regex, torch_key_template, kind)``.

The import goes through the flax names the port already speaks
(:func:`import_reference_state_dict`): the train module's tensors as a flat
flax tree (convert.py::state_to_flax), filled from the reference tensors by
:func:`apply_mapping`, then mapped onto the module by the strict
convert.py::flax_to_state_dict.  Layout rules (torch -> flax):

  Conv2d / Conv3d  (O, I, *spatial)  -> (*spatial, I, O)
  ConvTranspose2d  (I, O, kH, kW)    -> (kH, kW, I, O), taps flipped (the
                                        flax ConvTranspose correlates the
                                        zero-dilated input)
  Linear           (O, I)            -> (I, O)
  BatchNorm        weight / bias / running_mean / running_var
                                     -> scale / bias / mean / var
  GRUCell          weight_ih (3H, I) -> per-gate (I, H), gates (r, z, n)
  spconv           (kD, kH, kW, I, O) -> (kD kH kW, I, O)

Everything but reading the pickle is numpy.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

BN_LEAVES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
             'var': 'running_var'}


# --------------------------------------------------------------- tensor rules
def convert_conv(w: np.ndarray) -> np.ndarray:
    """(O, I, *spatial) -> (*spatial, I, O)."""
    return np.transpose(w, (*range(2, w.ndim), 1, 0))


def convert_conv_transpose(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose (I, O, kH, kW) -> flax (kH, kW, I, O) with the
    taps flipped."""
    nd = w.ndim
    w = np.transpose(w, (*range(2, nd), 0, 1))
    return np.flip(w, axis=tuple(range(nd - 2)))


def convert_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def split_gru_matrix(w: np.ndarray) -> Dict[str, np.ndarray]:
    """torch GRU packed (3H, I), gate order (r, z, n) -> per-gate (I, H)."""
    if w.shape[0] % 3:
        raise ValueError(f'a packed GRU matrix of {w.shape[0]} rows')
    h = w.shape[0] // 3
    return {'r': w[:h].T, 'z': w[h:2 * h].T, 'n': w[2 * h:].T}


def split_gru_bias(b: np.ndarray) -> Dict[str, np.ndarray]:
    h = b.shape[0] // 3
    return {'r': b[:h], 'z': b[h:2 * h], 'n': b[2 * h:]}


# ------------------------------------------------------------- torch loading
def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a torch ``.ckpt`` / ``.pth`` into {key: numpy array}: the
    ``state_dict`` of a Lightning checkpoint, or the file's dict itself.
    The pickle is a Lightning training checkpoint (hyperparameters,
    callbacks), so it is read with ``weights_only=False``: open only
    checkpoints you trust."""
    import torch
    raw = torch.load(path, map_location='cpu', weights_only=False)
    sd = raw.get('state_dict', raw) if isinstance(raw, dict) else raw
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, 'numpy')}


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str = 'model.'
                 ) -> Dict[str, np.ndarray]:
    """Drop the Lightning module's ``model.`` in front of each key."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


# ------------------------------------------------------------------- mapping
def _candidate(path: str, tkey: str, kind: str, sd: Dict[str, np.ndarray]):
    """(value, the torch key or keys it reads) of one rule for ``path``, or
    (None, None) when the state dict lacks a key the rule needs."""
    leaf = path.rsplit('/', 1)[-1]
    if kind == 'bn':
        key = f'{tkey}.{BN_LEAVES[leaf]}'
        return (sd[key], key) if key in sd else (None, None)
    if kind == 'gru':
        gate = path.split('/')[-2]            # ir, iz, in, hr, hz, hn
        side = 'ih' if gate[0] == 'i' else 'hh'
        if leaf == 'kernel':
            key = f'{tkey}.weight_{side}'
            split = split_gru_matrix
        else:
            key = f'{tkey}.bias_{side}'
            split = split_gru_bias
        return ((split(sd[key])[gate[-1]], key) if key in sd
                else (None, None))
    if kind in ('conv_cat', 'raw_cat'):
        # '|'-joined torch keys concatenated on the output axis (fused
        # kernels and biases, e.g. a GRU's update || reset)
        keys = tuple(tkey.split('|'))
        if not all(k in sd for k in keys):
            return None, None
        parts = [sd[k] for k in keys]
        if kind == 'conv_cat':
            parts = [convert_conv(p) for p in parts]
        return np.concatenate(parts, axis=-1), keys
    if tkey not in sd:
        return None, None
    t = sd[tkey]
    if path.endswith('kernel') and kind == 'conv':
        return convert_conv(t), tkey
    if path.endswith('kernel') and kind == 'conv_transpose':
        return convert_conv_transpose(t), tkey
    if path.endswith('kernel') and kind == 'linear':
        return convert_linear(t), tkey
    if kind == 'spconv':
        # spconv's (kD, kH, kW, I, O) -> the engine's flat taps (taps, I, O)
        return np.asarray(t).reshape(-1, *t.shape[-2:]), tkey
    return t, tkey


def apply_mapping(flax_flat: Dict[str, np.ndarray],
                  sd: Dict[str, np.ndarray],
                  rules: Sequence[Tuple[str, str, str]],
                  strict_shapes: bool = True):
    """Fill the leaves of ``flax_flat`` ({'params/a/b/kernel': array}, in
    the order the JAX package flattens a tree: each level's keys sorted)
    from the reference state dict.

    For each leaf the rules are tried in order; a rule whose torch keys are
    absent, already taken by an earlier leaf (except 'gru', which splits one
    packed matrix over the gates) or of another shape falls through to the
    next (structure variants such as EfficientNet's blocks without an
    expand conv shift the BatchNorm numbering).  A leaf that only a
    wrong-shaped tensor matched raises under ``strict_shapes`` and is
    missing otherwise.  Each filled leaf is cast to the dtype of the leaf
    it replaces.  Returns (new flat tree, report) with report =
    {'filled', 'missing', 'unused_torch'}: the leaves filled, the leaves
    left as they were, and the torch keys no leaf took."""
    new_flat = dict(flax_flat)
    used: set = set()
    filled: List[str] = []
    missing: List[str] = []
    for path, value in flax_flat.items():
        want_shape = tuple(np.shape(value))
        got = None
        wrong_shape = None
        for pattern, template, kind in rules:
            m = re.fullmatch(pattern, path)
            if not m:
                continue
            cand, cand_used = _candidate(path, m.expand(template), kind, sd)
            if cand is None:
                continue
            keys = cand_used if isinstance(cand_used, tuple) else (cand_used,)
            if kind != 'gru' and any(k in used for k in keys):
                # one tensor never fills two leaves
                continue
            cand = np.asarray(cand)
            if cand.shape != want_shape:
                wrong_shape = (cand_used, cand.shape)
                continue
            got = cand
            used.update(keys)
            break
        if got is None:
            if wrong_shape is not None and strict_shapes:
                raise ValueError(
                    f'{path}: no rule matched with the right shape; best '
                    f'candidate {wrong_shape[0]} had {wrong_shape[1]}, '
                    f'expected {want_shape}')
            missing.append(path)
            continue
        new_flat[path] = got.astype(np.asarray(value).dtype)
        filled.append(path)
    unused = sorted(set(sd) - used)
    return new_flat, {'filled': filled, 'missing': missing,
                      'unused_torch': unused}


def without_ignored(report: Dict[str, List[str]],
                    ignored_torch: Sequence[str] = (),
                    ignored_flax: Sequence[str] = ()) -> Dict[str, List[str]]:
    """The report's ``missing`` and ``unused_torch`` without the names a
    rule table declares ignored (regexes matched in full)."""
    def keep(names, patterns):
        return [n for n in names
                if not any(re.fullmatch(p, n) for p in patterns)]
    return {'missing': keep(report['missing'], ignored_flax),
            'unused_torch': keep(report['unused_torch'], ignored_torch)}


def _flax_order(paths) -> List[str]:
    """``paths`` in the order the JAX package flattens a variable tree
    (each level's keys sorted), which decides the rules' fall-through."""
    return sorted(paths, key=lambda p: p.split('/'))


def import_reference_state_dict(cfg, sd: Dict[str, np.ndarray], rules,
                                strict_shapes: bool = True):
    """The port's train-module state_dict for ``cfg`` filled from the
    reference state dict ``sd`` (keys without Lightning's ``model.``).

    The train module (training/trainer.py::StreamingFlowTrainModule) is
    built with its own initialisation; its tensors as a flax tree
    (convert.py::state_to_flax, under ``params/`` and ``batch_stats/``) are
    filled by :func:`apply_mapping`, and the tree is mapped back onto the
    module by the strict convert.py::flax_to_state_dict.  A leaf no
    reference tensor fills keeps the module's own initialisation and is
    listed in the report's ``missing`` (the distribution head, which the
    reference never builds, always is).  Returns (state_dict, report)."""
    from ..convert import flax_to_state_dict, state_to_flax
    from ..training.trainer import StreamingFlowTrainModule
    module = StreamingFlowTrainModule(cfg)
    tree = state_to_flax(module)
    flat = {f'{col}/{p}': v for col in ('params', 'batch_stats')
            for p, v in tree[col].items()}
    flat = {p: flat[p] for p in _flax_order(flat)}
    new_flat, report = apply_mapping(flat, sd, rules, strict_shapes)
    variables = {col: {} for col in ('params', 'batch_stats')}
    for path, value in new_flat.items():
        col, rest = path.split('/', 1)
        variables[col][rest] = value
    # state_to_flax's leaves are fp32 copies; flax_to_state_dict casts each
    # back to the dtype of the tensor it fills
    return flax_to_state_dict(module, variables), report
