"""Training observability: scalar/video logging + on-device profiling.

Port of streamingflow_tpu/training/logging.py; the device trace is
``torch.profiler``'s (CPU and CUDA activities) in place of JAX's profiler.

Reference behaviours (SURVEY.md §5): TensorBoardLogger (train.py:64),
per-loss scalars each step (trainer.py:406-407), uncertainty-weight tracking
(trainer.py:426-486), BEV prediction videos every VIS_INTERVAL steps
(trainer.py:396-401), 'simple' profiler wall-time table (train.py:88).

TensorBoard writing uses torch.utils.tensorboard when importable; otherwise
scalars fall back to a JSONL event log so headless environments still
record everything.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    """Scalar + video logger (TensorBoard or JSONL fallback)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._jsonl = open(os.path.join(log_dir, 'events.jsonl'), 'a')
        # tensorboard's add_video needs moviepy; say so ONCE at startup
        # instead of letting every video call print a per-call warning
        if self._tb is not None:
            try:
                import moviepy  # noqa: F401
            except ImportError:
                print('streamingflow: moviepy not installed — BEV videos '
                      'will be saved as .npz next to the event log instead '
                      'of TensorBoard video summaries', flush=True)
                self._video_fallback = True
            else:
                self._video_fallback = False
        else:
            self._video_fallback = True

    def scalar(self, tag: str, value, step: int):
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {'tag': tag, 'value': value, 'step': step,
                 'ts': time.time()}) + '\n')

    def scalars(self, values: Dict[str, float], step: int, prefix: str = ''):
        for k, v in values.items():
            try:
                self.scalar(f'{prefix}{k}', float(np.asarray(v)), step)
            except (TypeError, ValueError):
                pass

    def video(self, tag: str, frames: np.ndarray, step: int, fps: int = 2):
        """frames: (T, H, W, 3) uint8 (utils/visualisation.visualise_output)."""
        if self._tb is not None and not self._video_fallback:
            import torch
            vid = torch.from_numpy(frames[None]).permute(0, 1, 4, 2, 3)
            self._tb.add_video(tag, vid, step, fps=fps)
        # npz fallback next to the event log (no tensorboard, or no moviepy)
        else:
            np.savez_compressed(
                os.path.join(self.log_dir, f'{tag.replace("/", "_")}'
                                           f'_{step}.npz'), video=frames)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        else:
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


class SimpleProfiler:
    """Wall-time span table (the reference Lightning profiler='simple')."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = ['| span | calls | total s | mean ms |',
                '|---|---|---|---|']
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, n = self.totals[name], self.counts[name]
            rows.append(f'| {name} | {n} | {tot:.2f} | {tot / n * 1e3:.1f} |')
        return '\n'.join(rows)


@contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block (CPU and, where present, CUDA
    activities), written as a Chrome trace ``trace.json`` under
    ``log_dir``; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
