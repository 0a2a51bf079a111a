"""GRU-ODE with Bayesian jumps over an event tape.

Port of streamingflow_tpu/layers/ode.py.  The timeline is the same masked
tape: observation events, then target events, each of ``K`` solver
sub-steps (K = 1 with variable steps).  Per-sample timestamps are handled
with per-sample masks, so a sample whose event time is already reached
keeps its state and time.  Eager PyTorch runs the tape as a Python loop.

Path recording and target selection are those of the JAX package:
observation events record the post-jump state at the observation time;
target events record every in-window (+-delta_t/2) integration step, the
latest winning; each target takes the latest in-window record, falling back
to the nearest recorded time.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .srvp import ConvNet, SmallDecoder, SmallEncoder
from .temporal import DualGRUCell
from .trainmode import BatchShard, shard_draw


def softplus_rsample(raw_params: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     eps: float = 1e-8) -> torch.Tensor:
    """N(loc, softplus(raw_scale) + eps) from params split on the channel
    axis (dim 1), reparameterised with the given standard-normal ``noise``
    (shaped like loc).  With no noise the mean is returned."""
    loc, raw_scale = torch.chunk(raw_params, 2, dim=1)
    if noise is None:
        return loc
    return loc + (F.softplus(raw_scale) + eps) * noise


class GRUODEBayes(nn.Module):
    """NNFOwithBayesianJumps on a masked event tape.

    forward(obs_times (B, E_obs), obs (B, E_obs, C, H, W),
            inp (B, 1, C, H, W), target_times (B, E_tgt), generator)
    -> decoded per-target states (B, E_tgt, C, H, W).  Times are seconds
    relative to the present frame.  ``generator`` feeds the latent sampling
    when ``stochastic``."""

    # the global batch this forward's batch is a shard of: the noise is
    # drawn at its shape (layers/trainmode.py::set_shard)
    shard: Optional[BatchShard] = None

    def __init__(self, input_size: int, hidden_size: int, delta_t: float,
                 solver: str = 'euler', impute: bool = False,
                 variable_step: bool = False, srvp_filter_size: int = 64,
                 skipco: bool = False, max_gap_seconds: float = 0.6,
                 stochastic: bool = True):
        super().__init__()
        if solver not in ('euler', 'midpoint'):
            raise ValueError(f'Unknown solver {solver}')
        self.delta_t = delta_t
        self.solver = solver
        self.impute = impute
        self.variable_step = variable_step
        self.max_gap_seconds = max_gap_seconds
        self.stochastic = stochastic
        self.gru_c = DualGRUCell(input_size, hidden_size, return_delta=True)
        self.gru_obs = DualGRUCell(input_size, hidden_size,
                                   return_delta=False)
        self.p_model = ConvNet(hidden_size, hidden_size * 2)
        self.srvp_encoder = SmallEncoder(input_size, input_size,
                                         srvp_filter_size)
        self.srvp_decoder = SmallDecoder(input_size, input_size,
                                         srvp_filter_size, skip=skipco)

    # ------------------------------------------------------------ pieces
    def _infer_state(self, state, generator):
        params = self.p_model(state)
        noise = None
        if self.stochastic:
            loc_shape = (params.shape[0], params.shape[1] // 2,
                         *params.shape[2:])
            noise = shard_draw(
                lambda s: torch.randn(s, generator=generator,
                                      dtype=params.dtype,
                                      device=params.device),
                loc_shape, self.shard)
        return softplus_rsample(params, noise)

    def _dh(self, inp, state):
        if not self.impute:
            inp = torch.zeros_like(inp)
        return self.gru_c(inp, state)

    def _ode_step(self, state, inp, dt_b, generator):
        if self.solver == 'euler':
            state = state + dt_b * self._dh(inp, state)
        else:
            k = state + dt_b / 2 * self._dh(inp, state)
            pk = self._infer_state(k, generator)
            state = state + dt_b * self._dh(pk, k)
        return state, self._infer_state(state, generator)

    def _masked_substep(self, state, inp, current_time, event_time, is_obs,
                        generator):
        gap = event_time - current_time
        # obs phase: step while current_time <= obs_time - delta_t;
        # target phase: step while current_time < target_time
        do_step = gap >= self.delta_t if is_obs else gap > 0.0
        dt = (gap.clamp(min=0.0) if self.variable_step
              else torch.full_like(gap, self.delta_t))
        dt = torch.where(do_step, dt, torch.zeros_like(dt))
        dt_b = dt[:, None, None, None].to(state.dtype)
        new_state, new_inp = self._ode_step(state, inp, dt_b, generator)
        mask = do_step[:, None, None, None]
        return (torch.where(mask, new_state, state),
                torch.where(mask, new_inp, inp), current_time + dt, do_step)

    def _n_substeps(self) -> int:
        if self.variable_step:
            return 1
        return max(1, int(-(-self.max_gap_seconds // self.delta_t)))

    def _encode_seq(self, x):
        b, t = x.shape[:2]
        enc = self.srvp_encoder(x.reshape(b * t, *x.shape[2:]))
        return enc.reshape(b, t, *enc.shape[1:])

    # -------------------------------------------------------------- main
    def forward(self, obs_times, obs, inp, target_times,
                generator: Optional[torch.Generator] = None):
        B, E_obs = obs_times.shape
        E_tgt = target_times.shape[1]
        half = 0.5 * self.delta_t
        hx_obs = self._encode_seq(obs)
        inp_enc = self._encode_seq(inp)[:, 0]
        state = torch.zeros_like(inp_enc)
        dt0 = state.dtype
        current_time = obs_times.min(dim=1).values

        path_states, path_times, path_valid = [], [], []
        for e in range(E_obs):
            etime = obs_times[:, e]
            for _ in range(self._n_substeps()):
                state, inp_enc, current_time, _ = self._masked_substep(
                    state, inp_enc, current_time, etime, True, generator)
            state = self.gru_obs(hx_obs[:, e], state)
            inp_enc = self._infer_state(state, generator)
            state, inp_enc = state.to(dt0), inp_enc.to(dt0)
            path_states.append(state)
            path_times.append(etime)
            path_valid.append(torch.ones_like(etime, dtype=torch.bool))

        for e in range(E_tgt):
            ttime = target_times[:, e]
            rec_state = torch.zeros_like(state)
            rec_time = torch.full_like(current_time, math.inf)
            rec_valid = torch.zeros_like(current_time, dtype=torch.bool)
            for _ in range(self._n_substeps()):
                state, inp_enc, current_time, stepped = self._masked_substep(
                    state, inp_enc, current_time, ttime, False, generator)
                in_win = (stepped & (current_time > ttime - half)
                          & (current_time < ttime + half))
                rec_state = torch.where(in_win[:, None, None, None], state,
                                        rec_state)
                rec_time = torch.where(in_win, current_time, rec_time)
                rec_valid = rec_valid | in_win
            rec_time = torch.where(rec_valid, rec_time,
                                   torch.full_like(rec_time, math.inf))
            state, inp_enc = state.to(dt0), inp_enc.to(dt0)
            path_states.append(rec_state.to(dt0))
            path_times.append(rec_time)
            path_valid.append(rec_valid)

        states = torch.stack(path_states, 1)            # (B, E, C, h, w)
        pt = torch.stack(path_times, 1)[:, None, :]     # (B, 1, E)
        pv = torch.stack(path_valid, 1)[:, None, :]
        tt = target_times[:, :, None]                   # (B, E_tgt, 1)
        idx = torch.arange(pt.shape[-1], device=pt.device)
        in_win = pv & (pt > tt - half) & (pt < tt + half)
        idx_win = torch.where(in_win, idx, torch.full_like(idx, -1)).argmax(-1)
        dist = torch.where(pv, (pt - tt).abs(), torch.full_like(pt, math.inf))
        sel = torch.where(in_win.any(-1), idx_win, dist.argmin(-1))
        x = states[torch.arange(B, device=sel.device)[:, None], sel]
        dec = self.srvp_decoder(x.reshape(B * E_tgt, *x.shape[2:]))
        return dec.reshape(B, E_tgt, *dec.shape[1:])
