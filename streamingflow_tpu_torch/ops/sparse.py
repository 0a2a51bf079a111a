"""Sparse 3-D convolution over sorted, fixed-capacity site sets: the
'gather' engine of the spconv8x backbone.

Port of streamingflow_tpu/ops/sparse.py.  A sparse tensor is a slot array
of one point cloud,

    feats (V, C), coords (V, 3) int32 (x, y, z), ids (V,) int32 ascending
    (LARGE_ID where empty), mask (V,) bool,

its capacity V static.  A submanifold conv looks up the 27 neighbours of
every active site (binary search over the sorted ids) and contracts the
gathered rows with the weights in one product; a strided conv generates its
output sites analytically from the input sites (at most ceil(k/s) per dim
and input), keeps the ``cap`` lowest ids, and reuses the same product.
These are the reference spconv's active-site rules (SubMConv3d: outputs at
the input sites; SparseConv3d: at every site whose receptive field touches
an input, include/spconv/geometry.h:301).  The JAX package computes all of
this with XLA ops, outside any Pallas kernel, so its port is plain PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .voxelize import LARGE_ID, delinearize, linearize


class SparseTensor(NamedTuple):
    feats: torch.Tensor
    coords: torch.Tensor
    ids: torch.Tensor
    mask: torch.Tensor
    shape: Tuple[int, int, int]


def kernel_offsets(kernel: Tuple[int, int, int]) -> np.ndarray:
    """(prod(kernel), 3) tap offsets, x-major, z minor (the weights' tap
    order)."""
    kx, ky, kz = kernel
    return np.stack(np.meshgrid(np.arange(kx), np.arange(ky), np.arange(kz),
                                indexing='ij'), axis=-1).reshape(-1, 3)


def lookup(st: SparseTensor, query_coords: torch.Tensor,
           query_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots of ``query_coords`` (Q, 3) in ``st``: (index (Q,) long,
    found (Q,) bool), a binary search over the sorted ids."""
    nx, ny, nz = st.shape
    q = query_coords.long()
    inb = ((q[:, 0] >= 0) & (q[:, 0] < nx) & (q[:, 1] >= 0) & (q[:, 1] < ny)
           & (q[:, 2] >= 0) & (q[:, 2] < nz))
    ok = query_valid & inb
    qid = torch.where(ok, linearize(q, st.shape), LARGE_ID - 1)
    ids = st.ids.long().contiguous()
    idx = torch.searchsorted(ids, qid).clamp(0, ids.shape[0] - 1)
    found = ok & (ids[idx] == qid) & st.mask[idx]
    return idx, found


class NeighborMap(NamedTuple):
    """idx (K, V) long, found (K, V) bool: the slot of each tap of every
    site.  It depends only on the active sites, so one map serves every
    submanifold conv of a stage (spconv's cached indice pairs)."""
    idx: torch.Tensor
    found: torch.Tensor


def build_neighbor_map(st: SparseTensor, kernel: int = 3) -> NeighborMap:
    """The kernel**3 site-centred taps of every active site."""
    offsets = kernel_offsets((kernel,) * 3) - kernel // 2
    idxs, founds = [], []
    for off in offsets:
        idx, found = lookup(st, st.coords.long() + torch.as_tensor(
            off, device=st.coords.device), st.mask)
        idxs.append(idx)
        founds.append(found)
    return NeighborMap(torch.stack(idxs), torch.stack(founds))


class _GatherProduct(torch.autograd.Function):
    """rows (R, Cin), src (K, V) rows of ``rows`` (R: a zero row), weights
    (K, Cin, Cout) -> (V, Cout): the taps' rows gathered into (V, K*Cin)
    and one product.  The backward gathers them again rather than keep the
    (V, K*Cin) matrix (gigabytes at stages 3 and 4 of the flagship): d
    weights is its transpose times g, d rows the product g W^T added back
    into the rows under their taps."""

    @staticmethod
    def forward(ctx, rows, weights, src):
        ctx.save_for_backward(rows, weights, src)
        return _gathered(rows, src) @ weights.reshape(
            -1, weights.shape[2]).to(rows.dtype)

    @staticmethod
    def backward(ctx, g):
        rows, weights, src = ctx.saved_tensors
        k, cin, cout = weights.shape
        d_rows = d_weights = None
        if ctx.needs_input_grad[1]:
            d_weights = (_gathered(rows, src).t() @ g.to(rows.dtype)).reshape(
                k, cin, cout).to(weights.dtype)
        if ctx.needs_input_grad[0]:
            da = g.to(rows.dtype) @ weights.reshape(-1, cout).to(
                rows.dtype).t()
            d_rows = rows.new_zeros(rows.shape[0] + 1, cin).index_add_(
                0, src.t().reshape(-1), da.reshape(-1, cin))[:-1]
        return d_rows, d_weights, None


def _gathered(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(V, K*Cin): the rows under each of the K taps, zero where src is
    the row count."""
    k, v = src.shape
    padded = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    return padded[src.t().reshape(-1)].reshape(v, k * rows.shape[1])


def gather_product(rows: torch.Tensor, src: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """rows (R, Cin), src (K, V) long (R where a tap finds no row), weights
    (K, Cin, Cout) -> (V, Cout) in the rows' type; differentiable in rows
    and weights."""
    return _GatherProduct.apply(rows, weights, src)


def stacked_src(nmaps, v_in: int) -> torch.Tensor:
    """The maps of N clouds (each into its cloud's v_in slots) -> (K,
    N*V_out) rows of the clouds' stacked (N*v_in, C) rows, N*v_in where a
    tap finds no site: :func:`gather_product`'s src for one conv over all
    the clouds at once (the encoder's site convs)."""
    n = len(nmaps)
    return torch.cat([torch.where(m.found, m.idx + i * v_in, n * v_in)
                      for i, m in enumerate(nmaps)], 1)


def gather_gemm(feats: torch.Tensor, nmap: NeighborMap,
                weights: torch.Tensor, out_mask: torch.Tensor,
                bias=None) -> torch.Tensor:
    """One gather of the taps' rows (V, K*Cin) and one (V, K*Cin) @
    (K*Cin, Cout) product (:func:`gather_product` over
    :func:`stacked_src` of one cloud); weights (K, Cin, Cout); zero where
    out_mask is not set.  A plain product, computed outside any kernel in
    the JAX package too."""
    acc = gather_product(feats, stacked_src([nmap], feats.shape[0]),
                         weights)
    if bias is not None:
        acc = acc + bias
    return torch.where(out_mask[:, None], acc, 0)


def subm_conv3d(st: SparseTensor, weights: torch.Tensor, bias=None,
                nmap: NeighborMap = None) -> SparseTensor:
    """Submanifold conv, outputs at the active sites only; weights (K, Cin,
    Cout) with K a cube (27: 3x3x3, padding k // 2)."""
    k = round(weights.shape[0] ** (1 / 3))
    if k ** 3 != weights.shape[0]:
        raise ValueError(f'subm kernel must be cubic: {weights.shape[0]} '
                         f'taps')
    if nmap is None:
        nmap = build_neighbor_map(st, k)
    return st._replace(feats=gather_gemm(st.feats, nmap, weights, st.mask,
                                         bias))


def candidate_outputs_1d(i: torch.Tensor, k: int, s: int, p: int,
                         n_out: int):
    """Output positions o with o*s - p + t == i for a tap t in [0, k), at
    most ceil(k/s) of them: (cands, valid, taps), each (..., m)."""
    m = -(-k // s)
    o0 = torch.div(i + p, s, rounding_mode='floor')
    cands, valids, taps = [], [], []
    for j in range(m):
        o = o0 - j
        t = i + p - o * s
        valids.append((t >= 0) & (t < k) & (o >= 0) & (o < n_out))
        cands.append(o)
        taps.append(t)
    return torch.stack(cands, -1), torch.stack(valids, -1), \
        torch.stack(taps, -1)


def first_of_runs(sorted_ids: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    return first


def compact(values: torch.Tensor, head: torch.Tensor, rank: torch.Tensor,
            cap: int) -> torch.Tensor:
    """(cap,) long: the value of each run head at its rank, LARGE_ID
    elsewhere (the JAX package's segment_min)."""
    out = torch.full((cap,), LARGE_ID, dtype=torch.long,
                     device=values.device)
    return out.scatter_reduce_(
        0, torch.where(head, rank, cap).clamp(0, cap - 1),
        torch.where(head, values.long(), LARGE_ID), 'amin')


class OutputSites(NamedTuple):
    """A strided conv's output sites: ids (cap,) int32 ascending, coords
    (cap, 3) int32, mask (cap,); nmap the conv's (K, cap) taps into the
    input slots (None unless asked); src (cap,) long one contributing input
    slot of each output site, the least (None unless asked)."""
    ids: torch.Tensor
    coords: torch.Tensor
    mask: torch.Tensor
    nmap: NeighborMap = None
    src: torch.Tensor = None


def generate_output_sites(st: SparseTensor, kernel, stride, padding,
                          out_shape, cap: int, return_nmap: bool = False,
                          return_src: bool = False) -> OutputSites:
    """Active output sites of a strided conv, the ``cap`` lowest ids.

    Every active input site proposes its candidate outputs, each with its
    input slot and tap; the candidates are sorted by output id (stably, so
    a run of one output's candidates lists its input slots in ascending
    order), the head of each run takes the run's rank as its slot, and
    ranks past ``cap`` are dropped.  ``return_nmap``: the conv's taps,
    scattered from the sorted candidates (an output and a tap fix the
    input, so no two candidates collide).  ``return_src``: the run head's
    input slot."""
    k_total = math.prod(kernel)
    if k_total > 32:
        raise ValueError('a tap index packs into 5 bits')
    c = st.coords.long()
    cx, vx, tx = candidate_outputs_1d(c[:, 0], kernel[0], stride[0],
                                      padding[0], out_shape[0])
    cy, vy, ty = candidate_outputs_1d(c[:, 1], kernel[1], stride[1],
                                      padding[1], out_shape[1])
    cz, vz, tz = candidate_outputs_1d(c[:, 2], kernel[2], stride[2],
                                      padding[2], out_shape[2])
    val = (vx[:, :, None, None] & vy[:, None, :, None] & vz[:, None, None, :]
           & st.mask[:, None, None, None])
    ox, oy, oz = torch.broadcast_tensors(cx[:, :, None, None],
                                         cy[:, None, :, None],
                                         cz[:, None, None, :])
    cand = torch.where(val, linearize(torch.stack([ox, oy, oz], -1),
                                      out_shape), LARGE_ID).reshape(-1)
    tap = (tx[:, :, None, None] * (kernel[1] * kernel[2])
           + ty[:, None, :, None] * kernel[2] + tz[:, None, None, :])
    v_idx = torch.arange(c.shape[0], device=c.device)[:, None, None, None]
    payload = (v_idx * 32 + tap).expand(val.shape).reshape(-1)

    ids_s, order = torch.sort(cand, stable=True)
    pay_s = payload[order]
    first = first_of_runs(ids_s) & (ids_s < LARGE_ID)
    rank = torch.cumsum(first, 0) - 1
    head = first & (rank < cap)
    out_ids = compact(ids_s, head, rank, cap)
    out_mask = out_ids < LARGE_ID
    out_coords = torch.where(out_mask[:, None], delinearize(
        torch.where(out_mask, out_ids, 0), out_shape), 0)
    nmap = src = None
    if return_src:
        src = torch.zeros(cap + 1, dtype=torch.long, device=c.device)
        src[torch.where(head, rank, cap)] = pay_s >> 5
        src = src[:cap]
    if return_nmap:
        row_ok = (ids_s < LARGE_ID) & (rank < cap)
        flat = torch.where(row_ok, (pay_s & 31) * cap + rank, k_total * cap)
        idx = torch.zeros(k_total * cap + 1, dtype=torch.long,
                          device=c.device)
        found = torch.zeros(k_total * cap + 1, dtype=torch.bool,
                            device=c.device)
        idx[flat] = pay_s >> 5
        found[flat] = row_ok
        nmap = NeighborMap(idx[:-1].view(k_total, cap),
                           found[:-1].view(k_total, cap))
    return OutputSites(out_ids.int(), out_coords.int(), out_mask, nmap, src)


def conv_out_shape(shape, kernel, stride, padding):
    return tuple((shape[d] + 2 * padding[d] - kernel[d]) // stride[d] + 1
                 for d in range(3))


def sparse_conv3d(st: SparseTensor, weights: torch.Tensor, kernel, stride,
                  padding, cap: int, bias=None) -> SparseTensor:
    """Strided ("native") sparse conv: a new active set of ``cap`` slots;
    weights (prod(kernel), Cin, Cout)."""
    out_shape = conv_out_shape(st.shape, kernel, stride, padding)
    sites = generate_output_sites(st, kernel, stride, padding, out_shape,
                                  cap, return_nmap=True)
    feats = gather_gemm(st.feats, sites.nmap, weights, sites.mask, bias)
    return SparseTensor(feats, sites.coords, sites.ids, sites.mask,
                        out_shape)


def to_dense(st: SparseTensor) -> torch.Tensor:
    """(nx, ny, nz, C) grid, zero where no active site (SparseConvTensor.
    dense)."""
    nx, ny, nz = st.shape
    n_bins = nx * ny * nz
    flat = torch.where(st.mask, linearize(st.coords.long(), st.shape),
                       n_bins)
    dense = st.feats.new_zeros(n_bins + 1, st.feats.shape[-1])
    dense.index_put_((flat,), torch.where(st.mask[:, None], st.feats, 0),
                     accumulate=True)
    return dense[:n_bins].view(nx, ny, nz, -1)
