"""Streaming evaluation: predict at sub-keyframe intervals (0.05 s lattice).

Port of the JAX package's evaluate_streaming.py (reference
evaluate_streaming.py): enables multisweep labels (DATASET.USE_MULTISWEEP)
and subsamples the dense target timestamp lattice by ``--eval-interval``
(units of 0.05 s, reference :118-126).  The GRU-ODE decodes at exactly the
requested times; no retraining is involved.

    python -m streamingflow_tpu_torch.evaluate_streaming --checkpoint DIR
        [--eval-interval 2] [--device cpu]
"""
from __future__ import annotations

from typing import Dict, Optional

from .device import resolve_device
from .evaluate import build_eval_state, get_eval_parser, run_eval


def main(argv: Optional[list] = None) -> Dict:
    parser = get_eval_parser()
    parser.add_argument('--eval-interval', type=int, default=1,
                        help='prediction interval in 0.05 s units')
    args = parser.parse_args(argv)
    resolve_device(args.device)

    def mutate(cfg):
        cfg.DATASET.USE_MULTISWEEP = True

    cfg, ckpt = build_eval_state(args, cfg_mutator=mutate)
    # run_eval thins the future target lattice by the interval and
    # subsamples labels in lockstep at metric time (reference
    # evaluate_streaming.py:118-126, :142, :164); the short-interval
    # instance matcher is used unconditionally like the reference (:160).
    return run_eval(cfg, ckpt, short_interval=True,
                    eval_interval=args.eval_interval, device=args.device)


if __name__ == '__main__':
    main()
