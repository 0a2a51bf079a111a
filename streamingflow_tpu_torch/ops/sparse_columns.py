"""Column-sparse tensors: sparse over (x, y), dense over z.

Port of streamingflow_tpu/ops/sparse_columns.py (the column engine of the
spconv8x backbone).  A point cloud's active sites are grouped into columns
with a z-fused feature layout

    feats: (V_col, nz * C)   -- lane z*C + c

capped at a static number of column slots (ids ascending, the highest ids
dropped over the cap).  The per-column z occupancy ``zmask`` is the exact
active-site set of the reference's spconv, and every conv and BN masks by
it.  Here: the column set and its 9-tap in-plane neighbour map, the strided
("native") conv that makes the next stage's columns, and the entry into the
dense tail.  The submanifold conv over columns is ops/winfuse.py.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .voxelize import LARGE_ID


class ColumnSet(NamedTuple):
    """feats (V_col, nz*C); col_ids (V_col,) int32 = x*ny + y, ascending,
    LARGE_ID where empty; col_coords (V_col, 2) int32 (x, y); col_mask
    (V_col,) bool; zmask (V_col, nz) bool, the active sites.  A leading
    cloud axis is allowed on every field (see :func:`stack_sets`)."""
    feats: torch.Tensor
    col_ids: torch.Tensor
    col_coords: torch.Tensor
    col_mask: torch.Tensor
    zmask: torch.Tensor


class ColumnMap(NamedTuple):
    """The 9 in-plane neighbour slots of every column, x-major (dx, dy)
    order with the column itself at index 4: nbr (9, V_col) int32 (0 where
    not found), found (9, V_col) bool.  One map serves every submanifold
    conv of a stage."""
    nbr: torch.Tensor
    found: torch.Tensor


def stack_sets(sets) -> ColumnSet:
    return ColumnSet(*(torch.stack(f) for f in zip(*sets)))


def cloud(cs: ColumnSet, i: int) -> ColumnSet:
    return ColumnSet(*(f[i] for f in cs))


def _first_of_runs(sorted_ids: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    return first


def _compact(values: torch.Tensor, head: torch.Tensor, rank: torch.Tensor,
             cap: int) -> torch.Tensor:
    """(cap,) the value of each run head at its rank, LARGE_ID elsewhere
    (segment_min of the JAX package)."""
    out = torch.full((cap,), LARGE_ID, dtype=torch.long,
                     device=values.device)
    return out.scatter_reduce_(
        0, torch.where(head, rank, cap).clamp(0, cap - 1),
        torch.where(head, values, LARGE_ID), 'amin')


def from_sites(feats: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
               shape: Tuple[int, int, int], cap_cols: int) -> ColumnSet:
    """Sorted site rows feats (V, C) with x-major ids (z minor) -> ColumnSet
    of ``cap_cols`` column slots."""
    nx, ny, nz = shape
    C = feats.shape[1]
    ids = ids.long()
    cid = torch.where(mask, ids // nz, LARGE_ID)
    z = torch.where(mask, ids % nz, 0)
    first = _first_of_runs(cid) & mask
    rank = torch.cumsum(first, 0) - 1
    row_ok = mask & (rank < cap_cols)
    col_ids = _compact(cid, first & row_ok, rank, cap_cols)
    col_mask = col_ids < LARGE_ID
    col_coords = torch.stack([torch.where(col_mask, col_ids // ny, 0),
                              torch.where(col_mask, col_ids % ny, 0)], -1)
    # site (slot, z) of each row; rows past the cap go to a trash slot
    cell = torch.where(row_ok, rank, cap_cols) * nz + z
    fz = feats.new_zeros((cap_cols + 1) * nz, C)
    fz[cell] = torch.where(mask[:, None], feats, 0)
    zm = torch.zeros((cap_cols + 1) * nz, dtype=torch.bool,
                     device=feats.device)
    zm[cell] = row_ok
    return ColumnSet(fz[:cap_cols * nz].reshape(cap_cols, nz * C),
                     col_ids.int(), col_coords.int(), col_mask,
                     zm[:cap_cols * nz].reshape(cap_cols, nz))


def slot_table(col_ids: torch.Tensor, col_mask: torch.Tensor, n_cells: int,
               lead: int = 0) -> torch.Tensor:
    """Dense (lead + n_cells + 1,) int32 slot of each grid cell, -1 where
    empty; flat cell c at index lead + c (the lead cells let a window that
    starts at cell -1 stay in range)."""
    tbl = torch.full((lead + n_cells + 1,), -1, dtype=torch.int32,
                     device=col_ids.device)
    tbl[lead + torch.where(col_mask, col_ids.long(), n_cells)] = torch.arange(
        col_ids.shape[0], dtype=torch.int32, device=col_ids.device)
    return tbl


def window3(tbl_ext: torch.Tensor, cell_start: torch.Tensor) -> torch.Tensor:
    """(V, 3) slots of flat cells cell_start .. cell_start + 2 from a lead-1
    table.  The start is clamped into the table, as the JAX gather's
    mode='clip' clamps it."""
    start = (cell_start + 1).clamp(0, tbl_ext.shape[0] - 3)
    return tbl_ext[start[:, None] + torch.arange(3, device=start.device)]


def build_column_map(cs: ColumnSet, grid: Tuple[int, int]) -> ColumnMap:
    """One 3-wide window of the slot table per dx row."""
    nx, ny = grid
    cap = cs.col_ids.shape[0]
    tbl = slot_table(cs.col_ids, cs.col_mask, nx * ny, lead=1)
    x, y = cs.col_coords[:, 0].long(), cs.col_coords[:, 1].long()
    pos, found = [], []
    for dx in (-1, 0, 1):
        xq = x + dx
        x_ok = (xq >= 0) & (xq < nx) & cs.col_mask
        w = window3(tbl, torch.where(x_ok, xq * ny + y - 1, -1))
        for j, dy in enumerate((-1, 0, 1)):
            ok = x_ok & (y + dy >= 0) & (y + dy < ny) & (w[:, j] >= 0)
            pos.append(torch.where(ok, w[:, j], 0))
            found.append(ok)
    nbr, found = torch.stack(pos), torch.stack(found)
    nbr[4] = torch.arange(cap, dtype=torch.int32, device=nbr.device)
    found[4] = cs.col_mask
    return ColumnMap(nbr, found)


def mask_fused(x: torch.Tensor, zmask: torch.Tensor) -> torch.Tensor:
    """Zero the inactive cells of a fused (..., V, nz*C) tensor."""
    nz = zmask.shape[-1]
    xv = x.reshape(*x.shape[:-1], nz, x.shape[-1] // nz)
    return torch.where(zmask[..., None], xv, 0).reshape(x.shape)


def _candidate_outputs_1d(i: torch.Tensor, k: int, s: int, p: int,
                          n_out: int):
    """Output positions o with o*s - p + t == i for a tap t in [0, k)
    (ops/sparse.py of the JAX package): (cands (..., m), valid (..., m))."""
    m = -(-k // s)
    o0 = torch.div(i + p, s, rounding_mode='floor')
    cands, valids = [], []
    for j in range(m):
        o = o0 - j
        t = i + p - o * s
        valids.append((t >= 0) & (t < k) & (o >= 0) & (o < n_out))
        cands.append(o)
    return torch.stack(cands, -1), torch.stack(valids, -1)


def gen_output_columns(cs: ColumnSet, touches: torch.Tensor, kernel2, stride2,
                       pad2, out_grid, cap: int):
    """Active output columns of a strided conv: (ids, coords, mask), ids
    ascending.  ``touches`` (V,): the column has an active z that reaches a
    valid output z."""
    cx, vx = _candidate_outputs_1d(cs.col_coords[:, 0].long(), kernel2[0],
                                   stride2[0], pad2[0], out_grid[0])
    cy, vy = _candidate_outputs_1d(cs.col_coords[:, 1].long(), kernel2[1],
                                   stride2[1], pad2[1], out_grid[1])
    val = (vx[:, :, None] & vy[:, None, :]
           & (cs.col_mask & touches)[:, None, None])
    cand = torch.where(val, cx[:, :, None] * out_grid[1] + cy[:, None, :],
                       LARGE_ID).reshape(-1)
    ids_s = torch.sort(cand).values
    first = _first_of_runs(ids_s) & (ids_s < LARGE_ID)
    rank = torch.cumsum(first, 0) - 1
    out_ids = _compact(ids_s, first & (rank < cap), rank, cap)
    out_mask = out_ids < LARGE_ID
    out_coords = torch.stack([torch.where(out_mask, out_ids // out_grid[1], 0),
                              torch.where(out_mask, out_ids % out_grid[1], 0)],
                             -1)
    return out_ids.int(), out_coords.int(), out_mask


def z_touches_valid(nz_in: int, nz_out: int, kz: int, sz: int,
                    pz: int) -> np.ndarray:
    """(nz_in,) bool: input z that contributes to some valid output z."""
    touch = np.zeros((nz_in,), bool)
    for zo in range(nz_out):
        for tz in range(kz):
            zi = zo * sz - pz + tz
            if 0 <= zi < nz_in:
                touch[zi] = True
    return touch


def conv_out_shape(shape, kernel, stride, padding):
    return tuple((shape[d] + 2 * padding[d] - kernel[d]) // stride[d] + 1
                 for d in range(3))


def padded_rows(feats: torch.Tensor, nz: int, front: int,
                length: int) -> torch.Tensor:
    """Fused rows (R, nz*C) -> (R + 1, length, C): input z at front ..
    front + nz - 1, zeros around it and in row R, so that a tap that is
    not found (row R) and an input z outside [0, nz) read zeros."""
    rows = feats.shape[0]
    out = feats.new_zeros(rows + 1, max(length, front + nz),
                          feats.shape[1] // nz)
    out[:rows, front:front + nz] = feats.reshape(rows, nz, -1)
    return out


def z_windows(rows: torch.Tensor, nz_out: int, kz: int,
              sz: int) -> torch.Tensor:
    """Padded rows (V, length, C) -> (V, nz_out, C, kz): window zo holds
    padded z zo*sz .. zo*sz + kz - 1 (a view)."""
    return rows.unfold(1, kz, sz)[:, :nz_out]


def sparse_conv_columns(cs: ColumnSet, weights: torch.Tensor, kernel, stride,
                        padding, shape, cap: int
                        ) -> Tuple[ColumnSet, Tuple[int, int, int]]:
    """Strided sparse conv of one cloud: new active columns, outputs at
    every site an input touches (SparseConv3d semantics), dilated zmask.
    weights (prod(kernel), Cin, Cout), x-major taps.  Outputs are not
    masked (the masked BN after it masks them); each tap is multiplied and
    summed in the features' type, as the JAX package sums them."""
    nx, ny, nz = shape
    kz, sz, pz = kernel[2], stride[2], padding[2]
    out_shape = conv_out_shape(shape, kernel, stride, padding)
    nz_out = out_shape[2]
    dev = cs.feats.device
    ztv = torch.as_tensor(z_touches_valid(nz, nz_out, kz, sz, pz), device=dev)
    touches = (cs.zmask & ztv).any(-1)
    out_ids, out_coords, out_mask = gen_output_columns(
        cs, touches, kernel[:2], stride[:2], padding[:2], out_shape[:2], cap)

    # the input column under each in-plane tap of every output column
    tbl = slot_table(cs.col_ids, cs.col_mask, nx * ny, lead=1)
    ox, oy = out_coords[:, 0].long(), out_coords[:, 1].long()
    poss, inbs = [], []
    for tx in range(kernel[0]):
        ix = ox * stride[0] - padding[0] + tx
        x_ok = (ix >= 0) & (ix < nx) & out_mask
        iy0 = oy * stride[1] - padding[1]
        if kernel[1] == 3:
            w = window3(tbl, torch.where(x_ok, ix * ny + iy0, -1))
        for ty in range(kernel[1]):
            iy = iy0 + ty
            inb = x_ok & (iy >= 0) & (iy < ny)
            poss.append(w[:, ty] if kernel[1] == 3 else
                        tbl[1 + torch.where(inb, ix * ny + iy, -1)])
            inbs.append(inb)
    pos = torch.stack(poss)
    found = torch.stack(inbs) & (pos >= 0)
    src = torch.where(found, pos, cs.feats.shape[0]).long()

    # tap by tap, each a (V, nz_out, Cin*kz) x (Cin*kz, Cout) product,
    # summed in the features' type as the JAX package sums them
    cin, cout = weights.shape[1], weights.shape[2]
    length = (nz_out - 1) * sz + kz
    f = padded_rows(cs.feats, nz, pz, length)
    zm = padded_rows(cs.zmask, nz, pz, length)[..., 0]
    zm_out = torch.zeros(cap, nz_out, dtype=torch.bool, device=dev)
    out = None
    for k in range(src.shape[0]):
        x = z_windows(f.index_select(0, src[k]), nz_out, kz, sz)
        wk = weights[k * kz:(k + 1) * kz].permute(1, 0, 2)  # (Cin, kz, Cout)
        y = x.reshape(cap, nz_out, cin * kz) @ wk.reshape(
            cin * kz, cout).to(x.dtype)
        out = y if out is None else out + y
        # an output site is active where any contributing input site is
        zm_out |= z_windows(zm.index_select(0, src[k]), nz_out, kz,
                            sz).any(-1)
    out = out.reshape(cap, nz_out * cout)
    zm_out &= out_mask[:, None]
    return (ColumnSet(out, out_ids, out_coords, out_mask, zm_out),
            out_shape)


def columns_to_dense(cs: ColumnSet, shape: Tuple[int, int, int], C: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cloud's columns -> dense (nx, ny, nz, C) features (zero where
    inactive) and (nx, ny, nz) occupancy: the entry to the dense tail."""
    nx, ny, nz = shape
    idx = torch.where(cs.col_mask, cs.col_ids.long(), nx * ny)
    dense = cs.feats.new_zeros(nx * ny + 1, cs.feats.shape[-1])
    dense[idx] = mask_fused(cs.feats, cs.zmask)
    zm = torch.zeros(nx * ny + 1, nz, dtype=torch.bool, device=idx.device)
    zm[idx] = cs.zmask & cs.col_mask[:, None]
    return (dense[:nx * ny].reshape(nx, ny, nz, C),
            zm[:nx * ny].reshape(nx, ny, nz))
