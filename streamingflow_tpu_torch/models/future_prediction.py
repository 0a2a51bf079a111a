"""Future prediction: asynchronous observation merge + GRU-ODE + refinement.

Port of streamingflow_tpu/models/future_prediction.py.  Sequences are
(B, T, C, H, W).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers.conv import ConvNeXtBlock, DeepLabHead
from ..layers.ode import GRUODEBayes
from ..layers.temporal import SpatialGRU


def merge_observations(camera_states, camera_times, lidar_states,
                       lidar_times):
    """Merge two timestamped streams (states (B, T, C, H, W) or None, times
    (B, T)), stable-sorted by time per sample.
    Returns (times (B, T_all), states (B, T_all, C, H, W))."""
    streams = [(t, s) for t, s in ((camera_times, camera_states),
                                   (lidar_times, lidar_states))
               if s is not None]
    times = torch.cat([t for t, _ in streams], dim=1)
    states = torch.cat([s for _, s in streams], dim=1)
    order = torch.argsort(times, dim=1, stable=True)
    times = torch.gather(times, 1, order)
    states = states[torch.arange(states.shape[0],
                                 device=order.device)[:, None], order]
    return times, states


class FuturePredictionODE(nn.Module):

    def __init__(self, in_channels: int, latent_dim: int,
                 delta_t: float = 0.05, n_gru_blocks: int = 2,
                 n_res_layers: int = 1, solver: str = 'euler',
                 impute: bool = False, variable_step: bool = False,
                 srvp_filter_size: int = 64, skipco: bool = False,
                 max_gap_seconds: float = 0.6, stochastic: bool = True):
        super().__init__()
        self.n_gru_blocks = n_gru_blocks
        self.n_res_layers = n_res_layers
        self.gru_ode = GRUODEBayes(
            in_channels, latent_dim, delta_t, solver=solver, impute=impute,
            variable_step=variable_step, srvp_filter_size=srvp_filter_size,
            skipco=skipco, max_gap_seconds=max_gap_seconds,
            stochastic=stochastic)
        for i in range(n_gru_blocks):
            self.add_module(f'spatial_gru_{i}', SpatialGRU(
                in_channels, in_channels, in_channels))
            if i < n_gru_blocks - 1:
                for j in range(n_res_layers):
                    self.add_module(f'res_block_{i}_{j}',
                                    ConvNeXtBlock(in_channels))
            else:
                self.add_module(f'res_block_{i}', DeepLabHead(
                    in_channels, in_channels, hidden_channel=128))

    def forward(self, future_prediction_input, camera_states, camera_times,
                lidar_states, lidar_times, target_times,
                generator: Optional[torch.Generator] = None):
        """future_prediction_input: (B, 1, C, H, W) present state.
        Returns refined future states (B, T_target, C, H, W)."""
        obs_times, obs = merge_observations(camera_states, camera_times,
                                            lidar_states, lidar_times)
        x = self.gru_ode(obs_times, obs, future_prediction_input,
                         target_times, generator=generator)
        hidden_state = x[:, 0]
        for i in range(self.n_gru_blocks):
            x = getattr(self, f'spatial_gru_{i}')(x, hidden_state)
            b, s = x.shape[:2]
            flat = x.reshape(b * s, *x.shape[2:])
            if i < self.n_gru_blocks - 1:
                for j in range(self.n_res_layers):
                    flat = getattr(self, f'res_block_{i}_{j}')(flat)
            else:
                flat = getattr(self, f'res_block_{i}')(flat)
            x = flat.reshape(b, s, *flat.shape[1:])
        return x
