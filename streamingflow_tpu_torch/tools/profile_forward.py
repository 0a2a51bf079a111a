"""Where the flagship forward's, or training step's, time goes on the card.

    python3 -m streamingflow_tpu_torch.tools.profile_forward \
        [--backbone pillar8x|spconv8x] [--requests 5] [--train] \
        [--remat-ladder on|off] [--out runs/profile_forward.json]

Builds the flagship model (data.flagship_config: bench.py's full_cfg, on
the given LiDAR backbone) in bf16 with random weights from a seed, answers
one warm-up request and then ``--requests`` requests, and prints one JSON
line with:

  latency_s     host clock around each request (forward + synchronize)
  stages_ms     per request, CUDA-event time on the stream around each
                top-level stage (camera encoder, lift + pool, temporal
                models, LiDAR encoder, GRU-ODE future prediction, decoder);
                it counts the stream's idle gaps inside a stage too; on
                spconv8x also each child of the LiDAR encoder
                ('lidar_encoder.conv_input', ...) and the rest of it
                ('lidar_encoder.other': voxelize, column maps, dense entry)
  busy_share    device kernel time (torch.profiler) over wall time
  top_kernels   the kernels with the most device time, ms per request

With ``--train`` the requests are training steps
(training/trainer.py::train_step, fp32 parameters, batch 1, MODEL.REMAT as
configured): ``stages_ms`` then holds the stream time of the forward (stages
as above, first pass only), of the loss + backward (with the rematerialised
sub-modules' second pass) and of the optimizer.  On spconv8x also
``ladder_ms``: the LiDAR ladder's forward (its modules' first pass and the
geometry), its recompute under REMAT_LADDER (the modules' second pass),
K3's forward (its launches, recompute included), d feats and d weights
(CUDA events around each wrapper call; the recompute runs each checkpoint to
its end, not to torch.utils.checkpoint's early stop), and the strided
convs' backward
(down1 and down2 timed alone on the last step's inputs: forward and
backward less forward); ``--remat-ladder off`` turns the per-block
checkpoints off (MODEL.REMAT then checkpoints the ladder whole) to read
the peak memory without them.

Needs a CUDA card; raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from collections import defaultdict

import torch
import torch.utils.checkpoint

from ..device import pin_tf32

STAGES = ('encoder', 'temporal_model', 'lidar_encoder', 'lidar_reduce',
          'temporal_model_lidar', 'future_prediction', 'decoder')


def _device_us(evt) -> float:
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _event_ms(fn, reps=3):
    """Mean stream time of fn over reps runs after one warm-up (CUDA
    events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import flagship_config, make_batch

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--backbone', default='pillar8x',
                    choices=('pillar8x', 'spconv8x'))
    ap.add_argument('--requests', type=int, default=5)
    ap.add_argument('--train', action='store_true')
    ap.add_argument('--remat-ladder', choices=('on', 'off'), default='on')
    ap.add_argument('--out', default=os.path.join('runs',
                                                  'profile_forward.json'))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_forward: CUDA is not available')
    pin_tf32()
    dev = torch.device('cuda', 0)
    cfg = flagship_config(backbone=args.backbone)
    cfg.MODEL.SPARSE_ENCODER.REMAT_LADDER = args.remat_ladder == 'on'
    if args.train:
        trainer = P.build_trainer(cfg, device=dev, seed=0)
        model = trainer.module.model
    else:
        model = P.build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)

    marks = defaultdict(list)          # stage -> [(start, end) events]

    def span(a, b):
        """A pair's stream time; 0 for a pair without an end (a module
        left by an exception)."""
        return 0.0 if b is None else a.elapsed_time(b)

    def hook_pair(name):
        def pre(_module, _inputs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name].append([ev, None])

        def post(_module, _inputs, _output):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name][-1][1] = ev
        return pre, post

    hooked = [(name, getattr(model, name)) for name in STAGES
              if hasattr(model, name)]
    if args.backbone == 'spconv8x':
        hooked += [(f'lidar_encoder.{n}', m)
                   for n, m in model.lidar_encoder.named_children()]
    for name, mod in hooked:
        pre, post = hook_pair(name)
        mod.register_forward_pre_hook(pre)
        mod.register_forward_hook(post)

    bev_features = model.calculate_birds_eye_view_features

    def timed_bev(*a, **kw):
        pre, post = hook_pair('camera_lift_pool_total')
        pre(None, None)
        out = bev_features(*a, **kw)
        post(None, None, None)
        return out
    model.calculate_birds_eye_view_features = timed_bev

    if args.train:
        # the whole forward and the optimizer's update, beside the stages
        pre, post = hook_pair('forward')
        trainer.module.register_forward_pre_hook(pre)
        trainer.module.register_forward_hook(post)
        pre, post = hook_pair('optimizer')
        trainer.optimizer.register_step_pre_hook(
            lambda *_: pre(None, None))
        trainer.optimizer.register_step_post_hook(
            lambda *_: post(None, None, None))

    ladder = args.train and args.backbone == 'spconv8x'
    inputs = {}
    if ladder:
        from streamingflow_tpu_torch.ops import winfuse as WF

        def timed(name, fn):
            def run(*a, **kw):
                pre, post = hook_pair(name)
                pre(None, None)
                out = fn(*a, **kw)
                post(None, None, None)
                return out
            return run
        WF._conv = timed('k3_forward', WF._conv)
        WF.subm_conv_dgrad = timed('k3_dgrad', WF.subm_conv_dgrad)
        WF.subm_conv_wgrad = timed('k3_wgrad', WF.subm_conv_wgrad)
        for name in ('down1', 'down2'):
            getattr(model.lidar_encoder, name).register_forward_pre_hook(
                lambda mod, a, name=name: inputs.__setitem__(name, a))

    def request(seed):
        batch = make_batch(cfg, 1, seed=seed, n_points=80000)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if args.train:
            pre, post = hook_pair('step')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre(None, None)
            # the recompute runs each checkpointed module to its end (by
            # default it stops once it has what the backward needs, and its
            # modules' end events never fire)
            with torch.utils.checkpoint.set_checkpoint_early_stop(False):
                P.train_step(trainer, batch, generator=gen)
            post(None, None, None)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        inputs = P.batch_to_model_args(batch, cfg, device=dev,
                                       image_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model(**inputs, generator=gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    request(100)
    marks.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lat = [request(seed) for seed in range(1, args.requests + 1)]
    n = args.requests
    if args.train:
        # first pass of each stage only (the second is the recompute inside
        # the backward), and what is left of the step after the forward and
        # the optimizer is the loss and the backward
        per = {k: len(v) // n for k, v in marks.items()}
        stages = {k: sum(span(a, b) for i, (a, b) in enumerate(v)
                         if k in ('step', 'forward', 'optimizer',
                                  'camera_lift_pool_total')
                         or i % per[k] < (per[k] + 1) // 2) / n
                  for k, v in marks.items()}
        stages['loss_backward'] = (stages['step'] - stages['forward']
                                   - stages['optimizer'])
    else:
        stages = {k: sum(span(a, b) for a, b in v) / n
                  for k, v in marks.items()}
    # the lift + pool is the camera BEV stage without its encoder
    if 'camera_lift_pool_total' in stages:
        stages['camera_lift_pool'] = (stages.pop('camera_lift_pool_total')
                                      - stages.get('encoder', 0.0))
    children = [v for k, v in stages.items()
                if k.startswith('lidar_encoder.')]
    if children and 'lidar_encoder' in stages:
        stages['lidar_encoder.other'] = stages['lidar_encoder'] - sum(children)
    if ladder:
        enc_children = [k for k in marks if k.startswith('lidar_encoder.')]
        first = sum(stages[k] for k in enc_children)
        both = sum(sum(span(a, b) for a, b in marks[k]) / n
                   for k in enc_children)
        # the encoder's own hooks do not fire when MODEL.REMAT checkpoints
        # the ladder whole (REMAT_LADDER off): then its modules' first pass
        ladder_ms = {'forward': stages.get('lidar_encoder', first),
                     'recompute': both - first,
                     **{k: sum(span(a, b) for a, b in marks[k]) / n
                        for k in ('k3_forward', 'k3_dgrad', 'k3_wgrad')},
                     'launches': {k: len(marks[k]) // n for k in
                                  ('k3_forward', 'k3_dgrad', 'k3_wgrad')}}
        for name, (feats, nz, geo) in inputs.items():
            down = getattr(model.lidar_encoder, name)
            feats = feats.detach().requires_grad_()
            cot = torch.randn_like(down(feats, nz, geo))

            def fwd():
                return down(feats, nz, geo)

            def fwd_bwd():
                down(feats, nz, geo).backward(cot)
            fwd_ms, both_ms = (_event_ms(f) for f in (fwd, fwd_bwd))
            ladder_ms[f'{name}_forward'] = fwd_ms
            ladder_ms[f'{name}_backward'] = both_ms - fwd_ms
        for k in list(stages):
            if k.startswith('k3_'):
                stages.pop(k)
    # device-side events only (kernels, copies): the host ops that launched
    # them carry the same time again
    kernels = [(e.key, _device_us(e)) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    busy_us = sum(us for _, us in kernels)
    top = sorted(kernels, key=lambda kv: -kv[1])[:15]
    smi = os.popen('nvidia-smi --query-gpu=name,power.limit '
                   '--format=csv,noheader').read().strip()
    result = {
        'card': smi, 'backbone': args.backbone, 'requests': n,
        'mode': 'train' if args.train else 'forward',
        'latency_s': lat,
        'median_latency_s': statistics.median(lat),
        'stages_ms': stages,
        'busy_share': busy_us / 1e6 / sum(lat),
        'device_kernel_ms_per_request': busy_us / 1e3 / n,
        'top_kernels': [{'name': k[:90], 'ms_per_request': us / 1e3 / n}
                        for k, us in top],
        'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    if ladder:
        result['remat_ladder'] = args.remat_ladder
        result['ladder_ms'] = ladder_ms
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
