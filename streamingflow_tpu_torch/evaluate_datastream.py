"""Datastream evaluation: vary the LiDAR input stream rate.

Port of the JAX package's evaluate_datastream.py (reference
evaluate_datastream.py): sweeps ``cfg.DATASET.FRAME_SKIP`` (LiDAR
observation rate = 20/FRAME_SKIP Hz, reference :43) to measure robustness
to slower sensor streams.

    python -m streamingflow_tpu_torch.evaluate_datastream --checkpoint DIR
        [--frame-skip 4] [--device cpu]
"""
from __future__ import annotations

from typing import Dict, Optional

from .device import resolve_device
from .evaluate import build_eval_state, get_eval_parser, run_eval


def main(argv: Optional[list] = None) -> Dict:
    parser = get_eval_parser()
    parser.add_argument('--frame-skip', type=int, default=4,
                        help='group this many 20 Hz sweeps per observation')
    args = parser.parse_args(argv)
    resolve_device(args.device)

    def mutate(cfg):
        cfg.DATASET.FRAME_SKIP = args.frame_skip

    cfg, ckpt = build_eval_state(args, cfg_mutator=mutate)
    return run_eval(cfg, ckpt, device=args.device)


if __name__ == '__main__':
    main()
