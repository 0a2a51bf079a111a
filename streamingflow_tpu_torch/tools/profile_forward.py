"""Where the flagship forward's, or training step's, time goes on the card.

    python3 -m streamingflow_tpu_torch.tools.profile_forward \
        [--backbone pillar8x|spconv8x] [--requests 5] [--train] \
        [--out runs/profile_forward.json]

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

With ``--train`` (pillar8x only) the requests are training steps
(training/trainer.py::train_step, fp32 parameters, batch 1, MODEL.REMAT as
configured): ``stages_ms`` then holds the stream time of the forward (stages
as above, first pass only), of the loss + backward (with the rematerialised
sub-modules' second pass) and of the optimizer.

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

STAGES = ('encoder', 'temporal_model', 'lidar_encoder', 'lidar_reduce',
          'temporal_model_lidar', 'future_prediction', 'decoder')


def _device_us(evt) -> float:
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    import streamingflow_tpu_torch as P
    from streamingflow_tpu_torch.data import flagship_config, make_batch

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--backbone', default='pillar8x',
                    choices=('pillar8x', 'spconv8x'))
    ap.add_argument('--requests', type=int, default=5)
    ap.add_argument('--train', action='store_true')
    ap.add_argument('--out', default=os.path.join('runs',
                                                  'profile_forward.json'))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_forward: CUDA is not available')
    if args.train and args.backbone != 'pillar8x':
        raise SystemExit('profile_forward: --train takes pillar8x only (the '
                         'spconv8x backbone has no train mode yet)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    cfg = flagship_config(backbone=args.backbone)
    if args.train:
        trainer = P.build_trainer(cfg, device=dev, seed=0)
        model = trainer.module.model
    else:
        model = P.build_model(cfg, device=dev, dtype=torch.bfloat16, seed=0)

    marks = defaultdict(list)          # stage -> [(start, end) events]

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

    def request(seed):
        batch = make_batch(cfg, 1, seed=seed, n_points=80000)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if args.train:
            pre, post = hook_pair('step')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre(None, None)
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
        stages = {k: sum(a.elapsed_time(b) for i, (a, b) in enumerate(v)
                         if k in ('step', 'forward', 'optimizer',
                                  'camera_lift_pool_total')
                         or i % per[k] < (per[k] + 1) // 2) / n
                  for k, v in marks.items()}
        stages['loss_backward'] = (stages['step'] - stages['forward']
                                   - stages['optimizer'])
    else:
        stages = {k: sum(a.elapsed_time(b) for a, b in v) / n
                  for k, v in marks.items()}
    # the lift + pool is the camera BEV stage without its encoder
    if 'camera_lift_pool_total' in stages:
        stages['camera_lift_pool'] = (stages.pop('camera_lift_pool_total')
                                      - stages.get('encoder', 0.0))
    children = [v for k, v in stages.items()
                if k.startswith('lidar_encoder.')]
    if children:
        stages['lidar_encoder.other'] = stages['lidar_encoder'] - sum(children)
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
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
