"""LSS-legacy helpers + Kalman filter.

Port of streamingflow_tpu/utils/tools.py (reference streamingflow/utils/
tools.py: gen_dx_bx:176, cumsum_trick:184, KalmanFilter:392), dormant in
the shipped config.  ``gen_dx_bx`` and ``KalmanFilter`` are numpy copies;
``cumsum_trick`` is the sorted interval sum in torch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gen_dx_bx(xbound, ybound, zbound):
    """Grid resolution dx, first-cell centre bx, cell count nx
    (reference utils/tools.py:176-182)."""
    dx = np.array([row[2] for row in (xbound, ybound, zbound)], np.float32)
    bx = np.array([row[0] + row[2] / 2.0
                   for row in (xbound, ybound, zbound)], np.float32)
    nx = np.array([round((row[1] - row[0]) / row[2])
                   for row in (xbound, ybound, zbound)], np.int64)
    return dx, bx, nx


def cumsum_trick(x: torch.Tensor, ranks: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interval sums over sorted ranks by cumulative-sum differencing
    (reference utils/tools.py:184-193).

    x: (N, C) features sorted by rank; ranks: (N,) sorted bin ids.
    Returns (sums (N, C): at each run's last position the run's total,
    kept (N,): the runs' last positions)."""
    n = ranks.shape[0]
    csum = torch.cumsum(x, dim=0)
    kept = torch.cat([ranks[1:] != ranks[:-1],
                      torch.ones(1, dtype=torch.bool, device=x.device)])
    pos = torch.arange(n, device=x.device)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       kept[:-1]])
    # each position's run start: the last start at or before it
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                         dim=0).values
    before = torch.where((start > 0)[:, None],
                         csum[(start - 1).clamp(min=0)],
                         torch.zeros_like(csum))
    return csum - before, kept


class KalmanFilter:
    """Constant-velocity linear Kalman filter (reference tools.py:392-438,
    dormant in the shipped config)."""

    def __init__(self, state_dim: int = 4, obs_dim: int = 2, dt: float = 0.5):
        self.F = np.eye(state_dim)
        for i in range(obs_dim):
            self.F[i, obs_dim + i] = dt
        self.H = np.zeros((obs_dim, state_dim))
        self.H[:obs_dim, :obs_dim] = np.eye(obs_dim)
        self.Q = np.eye(state_dim) * 0.01
        self.R = np.eye(obs_dim) * 0.1

    def predict(self, x: np.ndarray, P: np.ndarray):
        x = self.F @ x
        P = self.F @ P @ self.F.T + self.Q
        return x, P

    def update(self, x: np.ndarray, P: np.ndarray, z: np.ndarray):
        y = z - self.H @ x
        S = self.H @ P @ self.H.T + self.R
        K = P @ self.H.T @ np.linalg.inv(S)
        x = x + K @ y
        P = (np.eye(len(x)) - K @ self.H) @ P
        return x, P

    def track(self, observations: np.ndarray) -> np.ndarray:
        """observations (T, obs_dim) -> filtered states (T, state_dim)."""
        d = self.F.shape[0]
        x = np.zeros(d)
        x[:observations.shape[1]] = observations[0]
        P = np.eye(d)
        out = [x.copy()]
        for z in observations[1:]:
            x, P = self.predict(x, P)
            x, P = self.update(x, P, z)
            out.append(x.copy())
        return np.stack(out)
