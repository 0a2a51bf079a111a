"""Convert a reference (PyTorch Lightning) checkpoint into a port checkpoint.

    python -m streamingflow_tpu_torch.tools.convert_checkpoint \
        --torch-ckpt model.ckpt --out DIR \
        --config-file configs/prediction_lc_ode_variable.yml \
        [--rules RULES.py] [--lenient-shapes] [KEY VALUE ...]

Reads the checkpoint's ``state_dict`` (Lightning's ``model.`` dropped),
builds the port's train module for the config (file, then ``KEY VALUE``
options) and fills every tensor a rule maps (utils/torch_convert.py:
conv / linear transposes, flipped transposed-conv taps, fused GRU gates,
BatchNorm statistics, spconv taps).  The result is written as step 0 of a
training/checkpoint.py directory, with the config beside it, so that
``python -m streamingflow_tpu_torch.evaluate --checkpoint DIR`` and the
``PRETRAINED`` warm start read it.  Adam's state is not carried.

The rule file defines ``RULES`` (and optionally ``IGNORED_TORCH`` and
``IGNORED_FLAX``, regexes); the default is the port's table of the
reference ``Prediction_LC_ODE_Variable`` model.  That table maps the
reference's sparse LiDAR encoder onto the ``spconv8x`` backbone: pass
``MODEL.LIDAR.BACKBONE spconv8x``, else its LiDAR keys are reported unused.

Prints one JSON line of the report's counts (``filled`` port leaves,
``missing`` leaves no reference tensor filled, which keep the module's own
initialisation, ``unused_torch`` reference keys nothing took; ``ignored``:
how many of the last two the rule file declares expected), then up to 40
names of each of ``missing`` and ``unused_torch``.  A tensor of the wrong
shape raises unless ``--lenient-shapes`` lists it as missing.  Runs on the
CPU: its output is weights.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
from typing import Dict, Optional

from ..config import get_cfg
from ..training.checkpoint import CheckpointManager
from ..utils import torch_convert as TC

DEFAULT_RULES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'rules_prediction_lc_ode_variable.py')


def load_rules(path: str):
    """The rule module of ``path`` (its ``RULES``, ``IGNORED_TORCH`` and
    ``IGNORED_FLAX``)."""
    spec = importlib.util.spec_from_file_location('ckpt_rules', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--torch-ckpt', required=True)
    ap.add_argument('--config-file', required=True)
    ap.add_argument('--rules', default=DEFAULT_RULES,
                    help='python file defining RULES (default: the '
                         'Prediction_LC_ODE_Variable table)')
    ap.add_argument('--out', required=True, help='output checkpoint dir')
    ap.add_argument('--lenient-shapes', action='store_true')
    ap.add_argument('opts', default=None, nargs=argparse.REMAINDER,
                    help='KEY VALUE config options')
    return ap


def main(argv: Optional[list] = None) -> Dict:
    """Run the conversion; returns the report and the checkpoint file."""
    args = get_parser().parse_args(argv)
    cfg = get_cfg(args)
    rules = load_rules(args.rules)
    sd = TC.strip_prefix(TC.load_torch_state_dict(args.torch_ckpt))
    state, report = TC.import_reference_state_dict(
        cfg, sd, rules.RULES, strict_shapes=not args.lenient_shapes)
    path = CheckpointManager(args.out).write(
        0, {'model': state, 'optimizer': None, 'optimizer_step': None,
            'generator': None}, cfg)
    kept = TC.without_ignored(report, getattr(rules, 'IGNORED_TORCH', ()),
                              getattr(rules, 'IGNORED_FLAX', ()))
    summary = {k: len(v) for k, v in report.items()}
    summary['ignored'] = {k: len(report[k]) - len(kept[k]) for k in kept}
    print(json.dumps(summary))
    for k in ('missing', 'unused_torch'):
        for item in report[k][:40]:
            print(f'{k}: {item}')
        if len(report[k]) > 40:
            print(f'{k}: ... {len(report[k]) - 40} more')
    return {'report': report, 'summary': summary, 'checkpoint': path}


if __name__ == '__main__':
    main()
