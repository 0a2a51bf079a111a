"""Temporal building blocks: causal 3-D convs and convolutional GRUs.

Port of streamingflow_tpu/layers/temporal.py.  2-D maps are NCHW; the 3-D
blocks take (B, C, T, H, W); the recurrent cells take (B, T, C, H, W)
sequences.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .conv import (Bottleblock, ConvNeXtBlock, batch_norm, conv2d,
                   resize_bilinear)


class GRUGates(nn.Module):
    """One conv-GRU cell update: gates + proposal, all 3x3 convs.

    The update and reset convs stay one fused kernel (``gates_kernel``,
    out = update || reset), laid out (2h, in + h, 3, 3).  Callers whose input
    sequence is known upfront (SpatialGRU) convolve the input half once for
    all steps with :meth:`precompute_x`, so each step convolves only the
    state half (conv([x, s]) = conv_x(x) + conv_s(s))."""

    def __init__(self, in_size: int, hidden_size: int):
        super().__init__()
        h, cx = hidden_size, in_size
        self.hidden_size, self.in_size = h, cx
        self.gates_kernel = nn.Parameter(torch.empty(2 * h, cx + h, 3, 3))
        self.gates_bias = nn.Parameter(torch.zeros(2 * h))
        self.proposal_kernel = nn.Parameter(torch.empty(h, cx + h, 3, 3))
        self.proposal_bias = nn.Parameter(torch.zeros(h))
        for w in (self.gates_kernel, self.proposal_kernel):
            nn.init.kaiming_uniform_(w, a=5 ** 0.5)

    def precompute_x(self, x):
        cx = self.in_size
        return (F.conv2d(x, self.gates_kernel[:, :cx], padding=1),
                F.conv2d(x, self.proposal_kernel[:, :cx], padding=1))

    def forward(self, x, state, x_pre=None):
        h, cx = self.hidden_size, self.in_size
        if x_pre is None:
            ur = F.conv2d(torch.cat([x, state], 1), self.gates_kernel,
                          padding=1)
        else:
            ur = F.conv2d(state, self.gates_kernel[:, cx:], padding=1) \
                + x_pre[0]
        ur = ur + self.gates_bias[:, None, None]
        update = torch.sigmoid(ur[:, :h])
        reset = torch.sigmoid(ur[:, h:])
        gated = (1.0 - reset) * state
        if x_pre is None:
            proposal = F.conv2d(torch.cat([x, gated], 1),
                                self.proposal_kernel, padding=1)
        else:
            proposal = F.conv2d(gated, self.proposal_kernel[:, cx:],
                                padding=1) + x_pre[1]
        proposal = proposal + self.proposal_bias[:, None, None]
        return (1.0 - update) * state + update * proposal


class SpatialGRU(nn.Module):
    """Conv GRU over a (B, T, C, H, W) sequence with a 1x1 output decoder."""

    def __init__(self, in_channels: int, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.GRUGates_0 = GRUGates(in_channels, hidden_size)
        self.Conv_0 = conv2d(hidden_size, input_size, 1)

    def forward(self, x, state=None):
        b, t, cx, h, w = x.shape
        rnn_state = (x.new_zeros(b, self.hidden_size, h, w)
                     if state is None else state)
        ur_x, p_x = self.GRUGates_0.precompute_x(x.reshape(b * t, cx, h, w))
        ur_x = ur_x.reshape(b, t, *ur_x.shape[1:])
        p_x = p_x.reshape(b, t, *p_x.shape[1:])
        states = []
        for i in range(t):
            rnn_state = self.GRUGates_0(None, rnn_state,
                                        x_pre=(ur_x[:, i], p_x[:, i]))
            states.append(rnn_state)
        out = self.Conv_0(torch.stack(states, 1).reshape(b * t, -1, h, w))
        return out.reshape(b, t, *out.shape[1:])


class DualGRUCell(nn.Module):
    """Dual GRU with trusting-gate mixing; the GRU-ODE jump update.

    With ``return_delta`` the output is (mixed - state), the continuous
    cell; otherwise the discrete one."""

    def __init__(self, in_channels: int, hidden_size: int,
                 return_delta: bool = False):
        super().__init__()
        self.return_delta = return_delta
        self.gru_cell_1 = GRUGates(in_channels, hidden_size)
        self.gru_cell_2 = GRUGates(hidden_size, hidden_size)
        self.Conv_0 = conv2d(hidden_size, hidden_size, 3, bias=True)
        self.trusting_gate_block = Bottleblock(2 * hidden_size, hidden_size)
        self.trusting_gate_conv = conv2d(hidden_size, 2, 1)

    def forward(self, x, state):
        rnn_state1 = self.gru_cell_1(x, state)
        rnn_state2 = self.Conv_0(self.gru_cell_2(state, state))
        gate = self.trusting_gate_block(torch.cat([rnn_state1, rnn_state2], 1))
        gate = torch.softmax(self.trusting_gate_conv(gate), dim=1)
        mixed = rnn_state2 * gate[:, 0:1] + rnn_state1 * gate[:, 1:2]
        return mixed - state if self.return_delta else mixed


class BiGRU(nn.Module):
    """Bidirectional conv GRU over a (B, T, C, H, W) sequence, the state of
    each direction started from the first (last) frame, a Bottleblock
    decoder a direction at each step, then a Bottleblock over both and two
    ConvNeXt blocks.  Each cell's input half is convolved for all steps
    at once (GRUGates.precompute_x), and the decoders run batched over time
    after the recurrence."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.cell_fwd = GRUGates(c, c)
        self.cell_bwd = GRUGates(c, c)
        self.dec_fwd = Bottleblock(c, c)
        self.dec_bwd = Bottleblock(c, c)
        self.Bottleblock_0 = Bottleblock(2 * c, c)
        self.ConvNeXtBlock_0 = ConvNeXtBlock(c)
        self.ConvNeXtBlock_1 = ConvNeXtBlock(c)

    def forward(self, x):
        b, s, c, h, w = x.shape
        flat = x.reshape(b * s, c, h, w)
        pre = [tuple(v.reshape(b, s, *v.shape[1:])
                     for v in cell.precompute_x(flat))
               for cell in (self.cell_fwd, self.cell_bwd)]
        state1, state2 = x[:, 0], x[:, -1]
        outs1, outs2 = [], []
        for t in range(s):
            r = s - t - 1
            state1 = self.cell_fwd(None, state1,
                                   x_pre=(pre[0][0][:, t], pre[0][1][:, t]))
            state2 = self.cell_bwd(None, state2,
                                   x_pre=(pre[1][0][:, r], pre[1][1][:, r]))
            outs1.append(state1)
            outs2.append(state2)
        st1 = torch.stack(outs1, 1).reshape(b * s, -1, h, w)
        st2 = torch.stack(outs2[::-1], 1).reshape(b * s, -1, h, w)
        out = torch.cat([self.dec_fwd(st1), self.dec_bwd(st2)], dim=1)
        out = self.ConvNeXtBlock_1(self.ConvNeXtBlock_0(
            self.Bottleblock_0(out)))
        return out.reshape(b, s, *out.shape[1:])


class CausalConv3d(nn.Module):
    """3-D conv with left-only temporal padding, BN, ReLU.
    Input (B, C, T, H, W)."""

    def __init__(self, cin: int, cout: int,
                 kernel_size: Tuple[int, int, int] = (2, 3, 3),
                 dilation: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel_size
        dt, dh, dw = dilation
        self.pad_t = (kt - 1) * dt
        self.Conv_0 = nn.Conv3d(cin, cout, kernel_size, dilation=dilation,
                                padding=(0, ((kh - 1) * dh) // 2,
                                         ((kw - 1) * dw) // 2), bias=False)
        self.BatchNorm_0 = batch_norm(cout)

    def forward(self, x):
        x = F.pad(x, (0, 0, 0, 0, self.pad_t, 0))
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class Conv1x1x1NormActivated(nn.Module):
    """1x1x1 conv + BN + ReLU on (B, C, T, H, W)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = nn.Conv3d(cin, cout, 1, bias=False)
        self.BatchNorm_0 = batch_norm(cout)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class Bottleneck3D(nn.Module):
    """3-D bottleneck with a causal conv, residual."""

    def __init__(self, cin: int, cout: Optional[int] = None,
                 kernel_size: Tuple[int, int, int] = (2, 3, 3),
                 dilation: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        cout = cout or cin
        mid = cin // 2
        self.Conv1x1x1NormActivated_0 = Conv1x1x1NormActivated(cin, mid)
        self.CausalConv3d_0 = CausalConv3d(mid, mid, kernel_size, dilation)
        self.Conv1x1x1NormActivated_1 = Conv1x1x1NormActivated(mid, cout)
        self.project = cout != cin
        if self.project:
            self.Conv_0 = nn.Conv3d(cin, cout, 1, bias=False)
            self.BatchNorm_0 = batch_norm(cout)

    def forward(self, x):
        h = self.Conv1x1x1NormActivated_0(x)
        h = self.CausalConv3d_0(h)
        h = self.Conv1x1x1NormActivated_1(h)
        if self.project:
            x = self.BatchNorm_0(self.Conv_0(x))
        return h + x


def avg_pool3d_no_pad_count(x: torch.Tensor, pool_size) -> torch.Tensor:
    """AvgPool3d(count_include_pad=False) over (B, C, T, H, W) with a
    (2, kh, kw) window, stride (1, kh, kw), one padded frame on each side
    of T and none in space, for windows that tile the plane (the pyramid
    pooling's (2, H, W)): a block mean, then a 2-tap temporal mean in which
    the edge frames average only their real neighbour."""
    kt, kh, kw = pool_size
    b, c, t, h, w = x.shape
    if kt != 2 or h % kh or w % kw:
        raise ValueError(f'pool window {tuple(pool_size)} does not tile '
                         f'{(t, h, w)} with a 2-frame kernel')
    blocks = x.reshape(b, c, t, h // kh, kh, w // kw, kw).mean(dim=(4, 6))
    mid = (blocks[:, :, 1:] + blocks[:, :, :-1]) * 0.5
    return torch.cat([blocks[:, :, :1], mid, blocks[:, :, -1:]], dim=2)


class PyramidSpatioTemporalPooling(nn.Module):
    """Spatio-temporal pyramid pooling on (B, C, T, H, W)."""

    def __init__(self, cin: int, reduction_channels: int,
                 pool_sizes: Sequence[Tuple[int, int, int]]):
        super().__init__()
        self.pool_sizes = [tuple(p) for p in pool_sizes]
        for i, _ in enumerate(self.pool_sizes):
            self.add_module(f'Conv1x1x1NormActivated_{i}',
                            Conv1x1x1NormActivated(cin, reduction_channels))

    def forward(self, x):
        b, _, t, h, w = x.shape
        out = []
        for i, pool_size in enumerate(self.pool_sizes):
            pooled = avg_pool3d_no_pad_count(x, pool_size)[:, :, :-1]
            pooled = getattr(self, f'Conv1x1x1NormActivated_{i}')(pooled)
            c, ph, pw = pooled.shape[1], pooled.shape[3], pooled.shape[4]
            flat = pooled.transpose(1, 2).reshape(b * t, c, ph, pw)
            flat = resize_bilinear(flat, (h, w))
            out.append(flat.reshape(b, t, c, h, w).transpose(1, 2))
        return torch.cat(out, dim=1)


class TemporalBlock(nn.Module):
    """Multi-path causal 3-D conv block with optional pyramid pooling, on
    (B, C, T, H, W)."""

    def __init__(self, cin: int, cout: Optional[int] = None,
                 use_pyramid_pooling: bool = False,
                 pool_sizes: Optional[Sequence[Tuple[int, int, int]]] = None):
        super().__init__()
        cout = cout or cin
        half = cin // 2
        self.Conv1x1x1NormActivated_0 = Conv1x1x1NormActivated(cin, half)
        self.CausalConv3d_0 = CausalConv3d(half, half, (2, 3, 3))
        self.Conv1x1x1NormActivated_1 = Conv1x1x1NormActivated(cin, half)
        self.CausalConv3d_1 = CausalConv3d(half, half, (1, 3, 3))
        self.Conv1x1x1NormActivated_2 = Conv1x1x1NormActivated(cin, half)
        n_res = 3 * half
        self.use_pyramid_pooling = use_pyramid_pooling
        if use_pyramid_pooling:
            if pool_sizes is None:
                raise ValueError('pyramid pooling needs pool_sizes')
            self.PyramidSpatioTemporalPooling_0 = PyramidSpatioTemporalPooling(
                cin, cin // 3, pool_sizes)
            n_res += len(pool_sizes) * (cin // 3)
        self.Conv1x1x1NormActivated_3 = Conv1x1x1NormActivated(n_res, cout)
        self.project = cout != cin
        if self.project:
            self.Conv_0 = nn.Conv3d(cin, cout, 1, bias=False)
            self.BatchNorm_0 = batch_norm(cout)

    def forward(self, x):
        paths = [self.CausalConv3d_0(self.Conv1x1x1NormActivated_0(x)),
                 self.CausalConv3d_1(self.Conv1x1x1NormActivated_1(x)),
                 self.Conv1x1x1NormActivated_2(x)]
        if self.use_pyramid_pooling:
            paths.append(self.PyramidSpatioTemporalPooling_0(x))
        residual = self.Conv1x1x1NormActivated_3(torch.cat(paths, dim=1))
        if self.project:
            x = self.BatchNorm_0(self.Conv_0(x))
        return x + residual
