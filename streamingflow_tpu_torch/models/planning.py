"""Command-conditioned trajectory planning head.

Port of streamingflow_tpu/models/planning.py (reference
streamingflow/models/planning_model.py: Planning:10, select:47-64,
max-margin loss:66-87, GRU refinement:129-145).  Submodule names follow the
flax variable paths (``reduce_channel/Bottleneck_i``, ``h0_proj``,
``gru/{ir,iz,in,hr,hz,hn}``, ``dec1``, ``dec2``), so convert.py maps a JAX
tree onto it by its rules.

* Commands are int codes (0 LEFT, 1 FORWARD, 2 RIGHT, 3 ALL); the
  command's third of the candidates is tiled to the full width
  (:func:`select_command_trajs`), so each candidate appears three times.
* The GRU cell is flax's ``GRUCell``: input Denses ``ir``, ``iz``, ``in``
  with biases, hidden Denses ``hr``, ``hz`` without and ``hn`` with one,
  n = tanh(W_in x + b_in + r * (W_hn h + b_hn)).  It is six Linear
  modules, not ``torch.nn.GRUCell``, whose two extra hidden biases would
  train where flax has none.
* Dense layers compute in the promoted type of their input and weights, as
  flax's do: a bf16 planner meeting fp32 trajectories refines in fp32.
* The front-camera feature (B, fh, fw, C), channels-last as the model
  emits it, goes through four bottlenecks and a global average pool.
  ``ReduceChannel`` skips a downsampling step once a side is below 2 px,
  as the JAX module does.  At an odd side of 5 or more the JAX module fails
  (its strided conv gives ceil(H / 2) rows, its residual's pool
  floor(H / 2), which broadcasts only from one row); the default 224 x 480
  images give a 28 x 60 feature, 7 x 15 at the third step.  Here the
  residual's pool then covers the odd side's last row or column
  (``Bottleneck(pool_ceil=True)``): the JAX result at every size where the
  JAX module runs.
* Under data parallelism (``shard``, set by layers.trainmode.set_shard)
  whether a goal point is set is taken over the global batch
  (ops/cost.py::progress_cost); the loss's batch means are the rank's,
  whose mean over equal shards is the global one, as for the other losses.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..layers.conv import Bottleneck
from ..layers.trainmode import BatchShard
from ..ops import cost as C


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in the promoted type of x and the weights (flax
    Dense's ``promote_dtype``)."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def select_command_trajs(trajs: torch.Tensor, commands: torch.Tensor,
                         num: int) -> torch.Tensor:
    """Pick the command's third of the sample set, tiled to full width.

    trajs (B, N, T, 3), commands (B,) int codes; N = 3 * num.
    Reference planning_model.py:104-115."""
    b, n = trajs.shape[:2]
    dev = trajs.device
    base = torch.arange(num, device=dev).repeat(n // num)        # (N,)
    commands = commands.to(device=dev, dtype=torch.long)
    valid = commands < 3
    offs = torch.where(valid, commands * num, torch.zeros_like(commands))
    idx = torch.where(valid[:, None], base[None] + offs[:, None],
                      torch.arange(n, device=dev)[None])
    return trajs[torch.arange(b, device=dev)[:, None], idx]


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (F.smooth_l1_loss, reduction='none')."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: r and z from ``ir`` / ``iz`` (biased) plus
    ``hr`` / ``hz`` (unbiased), n = tanh(in(x) + r * hn(h)), h' = (1 - z) n
    + z h."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for name in ('ir', 'iz', 'in'):
            self.add_module(name, nn.Linear(in_features, features))
        for name in ('hr', 'hz'):
            self.add_module(name, nn.Linear(features, features, bias=False))
        self.add_module('hn', nn.Linear(features, features))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        def g(name, v):
            return dense(getattr(self, name), v)
        r = torch.sigmoid(g('ir', x) + g('hr', h))
        z = torch.sigmoid(g('iz', x) + g('hz', h))
        n = torch.tanh(g('in', x) + r * g('hn', h))
        return (1.0 - z) * n + z * h


class ReduceChannel(nn.Module):
    """Strided bottleneck pyramid over the front-camera feature (reference
    planning_model.py:20-25) for an input of ``in_hw``: widths fc, fc / 2,
    fc / 2, fc / 8, the first three downsampling while both sides are at
    least 2 px.  Which steps downsample decides the parameters (an
    unstrided bottleneck of equal widths has no residual conv), so the
    module is built for one input size and refuses another."""

    def __init__(self, feature_channel: int, in_hw: Sequence[int]):
        super().__init__()
        fc = feature_channel
        self.in_hw = tuple(int(v) for v in in_hw)
        h, w = self.in_hw
        cin = fc
        for i, (c, ds) in enumerate([(fc, True), (fc // 2, True),
                                     (fc // 2, True), (max(fc // 8, 1),
                                                       False)]):
            ds = ds and min(h, w) >= 2
            self.add_module(f'Bottleneck_{i}', Bottleneck(
                cin, c, downsample=ds, pool_ceil=True))
            if ds:
                h, w = (h + 1) // 2, (w + 1) // 2
            cin = c
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> (B, C', H', W')."""
        if tuple(x.shape[-2:]) != self.in_hw:
            raise ValueError(f'ReduceChannel built for {self.in_hw}, given '
                             f'{tuple(x.shape[-2:])}')
        for i in range(4):
            x = getattr(self, f'Bottleneck_{i}')(x)
        return x


def feature_size(cfg: Config) -> Tuple[int, int]:
    """The camera encoder's feature size: the final image size over
    ENCODER.DOWNSAMPLE."""
    ds = cfg.MODEL.ENCODER.DOWNSAMPLE
    return tuple(int(v) // ds for v in cfg.IMAGE.FINAL_DIM)


class Planning(nn.Module):
    """Cost-based selection of a candidate + GRU refinement of it.  Train
    mode (``.train()``) adds the max-margin and Huber loss and takes batch
    statistics in the bottlenecks; eval mode returns a zero loss."""

    # the global batch this forward's batch is a shard of (set_shard)
    shard: Optional[BatchShard] = None

    def __init__(self, cfg: Config, feature_channel: int,
                 gru_state_size: int = 256,
                 feature_hw: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        self.sample_num = cfg.PLANNING.SAMPLE_NUM
        if self.sample_num % 3:
            raise ValueError(f'PLANNING.SAMPLE_NUM {self.sample_num} is not '
                             f'a multiple of 3')
        self.num = self.sample_num // 3
        self.grid = C.make_cost_grid(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.EGO.WIDTH, cfg.EGO.HEIGHT,
            cfg.COST_FUNCTION.LAMBDA)
        self.reduce_channel = ReduceChannel(
            feature_channel, feature_hw or feature_size(cfg))
        self.h0_proj = nn.Linear(self.reduce_channel.out_channels,
                                 gru_state_size)
        # input: the previous output (2), the selected candidate's step (2)
        # and the target point (2)
        self.gru = GRUCell(6, gru_state_size)
        self.dec1 = nn.Linear(gru_state_size, gru_state_size)
        self.dec2 = nn.Linear(gru_state_size, 2)

    def costs(self, trajs, cost_volume, semantic_pred, lane_divider,
              drivable_area, target_points
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cost_fc (B, N), cost_fo (B, N, T)) of (B, N, T, >= 2)
        trajectories (ops/cost.py::total_cost)."""
        pg = None if self.shard is None else self.shard.pg
        return C.total_cost(self.grid, self.cfg.COST_FUNCTION, cost_volume,
                            trajs[..., :2], semantic_pred, lane_divider,
                            drivable_area, target_points, pg=pg)

    @staticmethod
    def select(trajs, costs) -> torch.Tensor:
        """The candidate of least total cost (the first of equals;
        reference :47-64): trajs (B, N, T, 3) -> (B, T, 3)."""
        fc, fo = costs
        best = (fc + fo.sum(-1)).argmin(dim=1)
        return trajs[torch.arange(len(trajs), device=trajs.device), best]

    def loss(self, trajs, gt_trajs, costs, cost_volume, semantic_pred,
             lane_divider, drivable_area, target_points) -> torch.Tensor:
        """Max-margin: the ground truth's cost must undercut each
        candidate's by its L2 distance to the ground truth (reference
        :66-87).  ``costs``: the candidates' (:meth:`costs`)."""
        fc, fo = costs
        gt = gt_trajs[:, None]                            # (B, 1, T, 3)
        gfc, gfo = self.costs(gt, cost_volume, semantic_pred, lane_divider,
                              drivable_area, target_points)
        l2 = ((trajs[..., :2] - gt[..., :2]) ** 2).sum(-1).mean(-1)
        margin = F.relu(gfo - fo).sum(-1) + (gfc - fc) + l2
        return F.relu(margin).amax(-1).mean()

    def forward(self, cam_front, trajs, gt_trajs, cost_volume, semantic_pred,
                hd_map, commands, target_points
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cam_front (B, fh, fw, C); trajs (B, N, T, 3); gt_trajs (B, T, 3);
        cost_volume / semantic_pred (B, T, H, W); hd_map (B, 2 | 4, H, W);
        commands (B,) int; target_points (B, 2).  Returns (loss,
        output_traj (B, T, 3)).  Reference :89-150."""
        cur_trajs = select_command_trajs(trajs, commands, self.num)
        if hd_map.shape[1] == 2:
            lane_divider, drivable_area = hd_map[:, 0:1], hd_map[:, 1:2]
        elif hd_map.shape[1] == 4:
            lane_divider, drivable_area = hd_map[:, 0:2], hd_map[:, 2:4]
        else:
            raise NotImplementedError('hd_map must have 2 or 4 channels')
        maps = (cost_volume, semantic_pred, lane_divider, drivable_area,
                target_points)
        # the candidates' costs serve the loss and the selection both
        costs = self.costs(cur_trajs, *maps)

        h = self.reduce_channel(cam_front.permute(0, 3, 1, 2))
        h0 = dense(self.h0_proj, h.mean(dim=(2, 3)))      # (B, state)
        loss = torch.zeros((), dtype=h0.dtype, device=h0.device)
        if self.training:
            loss = self.loss(cur_trajs, gt_trajs, costs, *maps)

        final_traj = self.select(cur_trajs, costs)
        b, s, _ = final_traj.shape
        tp = target_points.to(h0.dtype)
        x = torch.zeros((b, 2), dtype=h0.dtype, device=h0.device)
        outs = []
        for i in range(s):
            inp = torch.cat([x, final_traj[:, i, :2], tp], dim=-1)
            h0 = self.gru(h0, inp)
            x = dense(self.dec2, F.relu(dense(self.dec1, h0)))
            outs.append(x)
        output_traj = torch.stack(outs, dim=1)            # (B, T, 2)
        output_traj = torch.cat(
            [output_traj, torch.zeros_like(output_traj[..., :1])], dim=-1)

        if self.training:
            huber = smooth_l1(output_traj[..., :2], gt_trajs[..., :2])
            weight = torch.tensor([10.0, 1.0], dtype=huber.dtype,
                                  device=huber.device)
            loss = loss * 0.5 + (huber * weight).mean()
        return loss, output_traj
