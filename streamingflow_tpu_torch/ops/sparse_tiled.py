"""The 'tiled' engine's capacity rule: occupied tiles, capped.

Port of the function of streamingflow_tpu/ops/sparse_tiled.py.  That engine
runs each stage's convs densely over the occupied 8x8x8 tiles of the voxel
grid (haloed tiles, one dense conv on the MXU), with the occupied tiles
capped at TILE_CAPS: the tiles of the highest tile ids past the cap are
dropped.  The dense tile convolutions are a TPU lowering of the gather
engine's sums and are not carried over; what the cap does to the function
is, and the encoder (models/lidar_encoder.py) runs it on the gather engine
(ops/sparse.py):

- a stage's sites whose tile ranks past the cap are dropped for the whole
  stage: they contribute nothing to its convs, read back zero, and the
  stage's masked batch norms take their statistics over the kept tiles'
  sites;
- the strided conv that ends the stage generates its output sites from all
  its input sites, kept or not, and an output site reads back zero when its
  least contributing input site (``generate_output_sites(...,
  return_src=True)``) lies in a dropped tile; that output still counts as
  active for the batch norm after it.

:func:`build_tile_map` is the JAX function's slot assignment and cap.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .sparse import compact, first_of_runs
from .voxelize import LARGE_ID, linearize

TILE_SHAPE = (8, 8, 8)


class TileMap(NamedTuple):
    """The occupied tiles of one cloud: tile_ids (T_cap,) int32 ascending,
    LARGE_ID where empty; tile_mask (T_cap,) bool; site_flat (V,) int32 the
    cell of each site, tile_slot * cells + local (x-major within the tile),
    T_cap * cells for a site that is not active or whose tile is past the
    cap; tile the tile's shape."""
    tile_ids: torch.Tensor
    tile_mask: torch.Tensor
    site_flat: torch.Tensor
    tile: Tuple[int, int, int]

    @property
    def kept(self) -> torch.Tensor:
        """(V,) bool: the site is active and its tile is under the cap."""
        return self.site_flat < self.tile_ids.shape[0] * math.prod(self.tile)

    @property
    def occupancy(self) -> torch.Tensor:
        """(T_cap, tx, ty, tz) bool, the active cells (built on request:
        the encoder reads only :attr:`kept`)."""
        n = self.tile_ids.shape[0] * math.prod(self.tile)
        occ = torch.zeros(n + 1, dtype=torch.bool,
                          device=self.site_flat.device)
        occ[self.site_flat.long()] = True
        return occ[:-1].view(-1, *self.tile)


def tile_grid(shape, tile) -> Tuple[int, int, int]:
    return tuple(-(-shape[d] // tile[d]) for d in range(3))


def build_tile_map(coords: torch.Tensor, ids: torch.Tensor,
                   mask: torch.Tensor, shape, cap_tiles: int,
                   tile=TILE_SHAPE) -> TileMap:
    """The active sites of one cloud into occupied tiles, the ``cap_tiles``
    lowest tile ids kept (one sort of the sites' tile ids)."""
    grid = tile_grid(shape, tile)
    cells = tile[0] * tile[1] * tile[2]
    c = coords.long()
    t = torch.as_tensor(tile, device=c.device)
    tid = torch.where(mask, linearize(c // t, grid), LARGE_ID)
    tid_s, order = torch.sort(tid, stable=True)
    first = first_of_runs(tid_s) & (tid_s < LARGE_ID)
    rank = torch.cumsum(first, 0) - 1
    row_ok = (tid_s < LARGE_ID) & (rank < cap_tiles)
    tile_ids = compact(tid_s, first & row_ok, rank, cap_tiles)
    slot = torch.empty_like(rank)
    slot[order] = torch.where(row_ok, rank, cap_tiles)
    local = ((c[:, 0] % tile[0]) * tile[1] + c[:, 1] % tile[1]) * tile[2] \
        + c[:, 2] % tile[2]
    site_flat = torch.where(mask & (slot < cap_tiles), slot * cells + local,
                            cap_tiles * cells)
    return TileMap(tile_ids.int(), tile_ids < LARGE_ID, site_flat.int(),
                   tuple(tile))


def dropped_sites(tmap: TileMap, mask: torch.Tensor) -> torch.Tensor:
    """Active sites past the tile capacity (a device scalar; 0 when
    TILE_CAPS is sized for the data)."""
    return mask.sum() - tmap.occupancy.sum()


def stage_tile_cap(cap: int, shape, tile) -> int:
    """A stage's tile capacity: TILE_CAPS[stage], at most the grid's
    tiles."""
    g = tile_grid(shape, tile)
    return min(cap, g[0] * g[1] * g[2])
