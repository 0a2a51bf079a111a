"""Trajectory cost library of the planning head (BEV raster costs).

Port of streamingflow_tpu/ops/cost.py (reference streamingflow/cost.py:
Cost_Function:10-47, BaseCost helpers :50-155, Cost_Volume:157, Rule:173,
SafetyCost:201, HeadwayCost:234, LR_divider:264, Comfort:307,
Progress:372).  The host part is a copy (numpy): the ego box rasterised
once (:func:`polygon_fill`) into a :class:`CostGrid`.  The costs are plain
PyTorch on the tensors' device; the JAX package computes them with XLA ops
outside any Pallas kernel.

* Sampling a raster under the ego footprint swept along each trajectory is
  one batched gather (:func:`compute_area`).
* The per-step loops of the reference (velocities, accelerations, jerk)
  are differences along the time axis.
* ``LR_divider``'s loop over the lane pixels is an exact running minimum
  over *all* grid cells, ``chunk`` cells at a time, with the cells off the
  lane at +inf; a trajectory's cell takes no gradient, so neither does this
  cost, and it runs without autograd.

Each function keeps the JAX function's order of clip and integer cast:
:func:`discretize` clips the floats and truncates, :func:`compute_area`
truncates and clips (``.to(torch.int32)`` truncates toward zero, as
``astype`` does).  A max over candidates that tie (``select_command_trajs``
repeats each candidate three times) splits its gradient evenly among them,
as JAX's reduce-max does (``torch.amax``).

Conventions: rasters are (B, T, H, W); trajectories are ego-frame metres
(B, N, T, 2) in the reference's (x, y) order; :func:`total_cost` flips x
(``trajs * [-1, 1]``, reference cost.py:35) before the sub-costs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.collect import all_reduce_sum


# --------------------------------------------------------------- host-side geo
def polygon_fill(pts: np.ndarray) -> np.ndarray:
    """All integer (row, col) cells inside a convex polygon.

    Pure-numpy replacement for skimage.draw.polygon as used at reference
    cost.py:81 (only ever called with the convex ego-box quad).  A cell
    (r, c) is inside when the point (r, c) lies within the polygon boundary
    (edges inclusive)."""
    pts = np.asarray(pts, np.float64)  # (K, 2) as (row, col)
    rmin, rmax = int(np.floor(pts[:, 0].min())), int(np.ceil(pts[:, 0].max()))
    cmin, cmax = int(np.floor(pts[:, 1].min())), int(np.ceil(pts[:, 1].max()))
    rr, cc = np.meshgrid(np.arange(rmin, rmax + 1), np.arange(cmin, cmax + 1),
                         indexing='ij')
    pr = np.stack([rr.ravel(), cc.ravel()], -1).astype(np.float64)
    inside = np.ones(len(pr), bool)
    n = len(pts)
    # convex polygon: point is inside iff on the same side of every edge
    sign = 0.0
    for i in range(n):
        a, b = pts[i], pts[(i + 1) % n]
        cross = ((b[0] - a[0]) * (pr[:, 1] - a[1])
                 - (b[1] - a[1]) * (pr[:, 0] - a[0]))
        edge_sign = np.sign(cross)
        if sign == 0.0 and np.any(edge_sign != 0):
            sign = edge_sign[np.argmax(edge_sign != 0)]
        inside &= (cross * sign >= -1e-9)
    return pr[inside].astype(np.int64)


def ego_box_points(bx, dx, ego_width: float, ego_height: float,
                   lam: float = 0.0) -> np.ndarray:
    """The ego box's corners (``lam`` cells wider on every side) in
    fractional (row, col) cells of a grid with first-cell centre ``bx`` and
    resolution ``dx``, as :func:`polygon_fill` takes them (reference
    cost.py:72-81)."""
    W, H = ego_width, ego_height
    pts = np.array([
        [-H / 2. + 0.5 - lam, W / 2. + lam],
        [H / 2. + 0.5 + lam, W / 2. + lam],
        [H / 2. + 0.5 + lam, -W / 2. - lam],
        [-H / 2. + 0.5 - lam, -W / 2. - lam]])
    pts = (pts - bx) / dx
    pts[:, [0, 1]] = pts[:, [1, 0]]
    return pts[:, ::-1]


class CostGrid(NamedTuple):
    """Static BEV discretisation + ego footprints, built once on host.

    dx/bx follow the reference's gen_dx_bx convention (utils/tools.py:176):
    dx = resolution, bx = centre of the first cell."""
    dx: np.ndarray            # (2,) metres per cell
    bx: np.ndarray            # (2,) first-cell centre
    bev_dimension: Tuple[int, int]
    footprint: np.ndarray     # (P, 2) ego-box cells around origin, padded
    footprint_mask: np.ndarray  # (P,) valid cells
    footprint_lam: np.ndarray   # (P, 2) inflated (safety-lambda) footprint
    footprint_lam_mask: np.ndarray


def make_cost_grid(x_bound, y_bound, ego_width: float, ego_height: float,
                   safety_lambda: float) -> CostGrid:
    """Grid constants + ego-box footprints (reference cost.py:50-83, once
    per module instead of per call)."""
    dx = np.array([x_bound[2], y_bound[2]], np.float32)
    bx = np.array([x_bound[0] + x_bound[2] / 2.0,
                   y_bound[0] + y_bound[2] / 2.0], np.float32)
    nx = int(round((x_bound[1] - x_bound[0]) / x_bound[2]))
    ny = int(round((y_bound[1] - y_bound[0]) / y_bound[2]))

    def box_cells(lam: float) -> np.ndarray:
        return polygon_fill(ego_box_points(bx, dx, ego_width, ego_height,
                                           lam))

    lam_cells = int(safety_lambda / float(dx[0]))
    base = box_cells(0)
    infl = box_cells(lam_cells)
    P = max(len(base), len(infl))

    def pad(cells):
        mask = np.zeros(P, bool)
        mask[:len(cells)] = True
        out = np.zeros((P, 2), np.int64)
        out[:len(cells)] = cells
        return out, mask

    fp, fp_m = pad(base)
    fl, fl_m = pad(infl)
    return CostGrid(dx, bx, (nx, ny), fp, fp_m, fl, fl_m)


# ----------------------------------------------------------------- primitives
def _float(t: torch.Tensor) -> torch.dtype:
    """The dtype JAX computes ``t`` with an fp32 constant in."""
    return torch.promote_types(t.dtype, torch.float32)


def discretize(grid: CostGrid, trajs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, T, 2) metres -> clipped integer (row, col) as int64.  The row
    comes from the y-component (trajs[..., 1]) and the column from the
    x-component, as the reference's get_points swaps them; the floats are
    clipped, then truncated."""
    t = trajs.to(_float(trajs))
    yi = ((t[..., 1] - float(grid.bx[0])) / float(grid.dx[0])).clamp(
        0, grid.bev_dimension[0] - 1).to(torch.int32)
    xi = ((t[..., 0] - float(grid.bx[1])) / float(grid.dx[1])).clamp(
        0, grid.bev_dimension[1] - 1).to(torch.int32)
    return yi.long(), xi.long()


def _gather_bt(raster: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor
               ) -> torch.Tensor:
    """raster (B, T, H, W); rr/cc (B, N, T, P) -> (B, N, T, P)."""
    B, T, H, W = raster.shape
    _, N, _, P = rr.shape
    idx = (rr * W + cc).permute(0, 2, 1, 3).reshape(B, T, N * P)
    vals = torch.gather(raster.reshape(B, T, H * W), 2, idx)
    return vals.reshape(B, T, N, P).permute(0, 2, 1, 3)


def compute_area(grid: CostGrid, raster: torch.Tensor, trajs: torch.Tensor,
                 ego_velocity: Optional[torch.Tensor] = None,
                 inflated: bool = False) -> torch.Tensor:
    """Sum ``raster`` over the ego footprint swept along each trajectory.

    raster (B, T, H, W), trajs (B, N, T, 2) -> (B, N, T).
    Reference cost.py:85-127 (get_points + compute_area)."""
    fp = grid.footprint_lam if inflated else grid.footprint
    fm = grid.footprint_lam_mask if inflated else grid.footprint_mask
    dt = _float(trajs)
    # reference get_points: trajs/dx first, then swap -> rows from y/dx1
    pix = (trajs.to(dt) / torch.as_tensor(grid.dx, dtype=dt,
                                          device=trajs.device)).flip(-1)
    pix = pix[..., None, :] + torch.as_tensor(fp, dtype=dt,
                                              device=trajs.device)
    rr = pix[..., 0].to(torch.int32).clamp(0, grid.bev_dimension[0] - 1)
    cc = pix[..., 1].to(torch.int32).clamp(0, grid.bev_dimension[1] - 1)
    mask = torch.as_tensor(fm, device=raster.device).to(raster.dtype)
    sub = (_gather_bt(raster, rr.long(), cc.long()) * mask).sum(-1)
    if ego_velocity is not None:
        sub = sub * ego_velocity
    return sub


def _previous(trajs: torch.Tensor) -> torch.Tensor:
    """Each step's predecessor along T, the origin before the first."""
    return torch.cat([torch.zeros_like(trajs[:, :, :1]), trajs[:, :, :-1]],
                     dim=2)


def _diff_from_zero(x: torch.Tensor) -> torch.Tensor:
    """``jnp.diff(x, axis=2, prepend=0)``: x_t - x_{t-1}, x_0 - 0."""
    return x - torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, :-1]],
                         dim=2)


def ego_velocity_profile(trajs: torch.Tensor, dt: float = 0.5
                         ) -> torch.Tensor:
    """Speed per step: |p_t - p_{t-1}| / dt, the first step from the origin
    (reference cost.py:215-221)."""
    return torch.sqrt(((trajs - _previous(trajs)) ** 2).sum(-1)) / dt


def _binary_channel(raster: torch.Tensor) -> torch.Tensor:
    """(B, 1 or 2, H, W) logits / mask -> (B, H, W) soft mask (reference
    cost.py:184-191: softmax channel 1, zero below 0.5)."""
    if raster.shape[1] == 2:
        prob = torch.softmax(raster, dim=1)[:, 1]
        return torch.where(prob < 0.5, torch.zeros_like(prob), prob)
    return raster[:, 0]


# --------------------------------------------------------------------- costs
def safety_cost(grid: CostGrid, trajs, semantic_pred, lam_factor: float,
                factor: float) -> torch.Tensor:
    """Occupancy swept at the nominal + velocity-weighted inflated footprint
    (reference SafetyCost:201-231)."""
    v = ego_velocity_profile(trajs)
    sub = (compute_area(grid, semantic_pred, trajs)
           + compute_area(grid, semantic_pred, trajs, v, inflated=True))
    return sub * factor


def headway_cost(grid: CostGrid, trajs, semantic_pred, drivable_area,
                 factor: float, lead_distance: float = 10.0) -> torch.Tensor:
    """Occupancy 10 m ahead within the drivable area (HeadwayCost:234-263)."""
    drivable = _binary_channel(drivable_area)
    masked = semantic_pred * drivable[:, None]
    ahead = trajs.clone()
    ahead[..., 1] = ahead[..., 1] + lead_distance
    return compute_area(grid, masked, ahead) * factor


def lr_divider_cost(grid: CostGrid, trajs, lane_divider, factor: float,
                    keep_distance: float = 1.0, chunk: int = 2048,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Quadratic penalty for driving within ``keep_distance`` of a lane
    divider (reference LR_divider:264-305, which loops over the lane's
    nonzero pixels).  Here: the exact running minimum of the squared
    distance over every cell, ``chunk`` cells at a time, with the cells off
    the lane at +inf; an empty lane raster gives 0.  The squared distances
    are fp32 (the JAX function's cell coordinates); the minimum and the
    penalty are in ``dtype`` (the JAX function's default float type, fp64
    under x64; default: the trajectories' float type).  (B, N, T); no
    gradient."""
    with torch.no_grad():
        lane = _binary_channel(lane_divider)               # (B, H, W)
        B, H, W = lane.shape
        dev = trajs.device
        dt = torch.promote_types(_float(trajs), dtype or torch.float32)
        yi, xi = discretize(grid, trajs)
        # trajectory cell centres in metres (cell * reversed(dx))
        ty = yi.to(torch.float32) * float(grid.dx[1])
        tx = xi.to(torch.float32) * float(grid.dx[0])
        lane_flat = lane.reshape(B, H * W)
        best = torch.full(yi.shape, float('inf'), dtype=dt, device=dev)
        for start in range(0, H * W, chunk):
            cell = torch.arange(start, min(start + chunk, H * W), device=dev)
            r = (cell // W).to(torch.float32) * float(grid.dx[1])
            c = (cell % W).to(torch.float32) * float(grid.dx[0])
            d2 = (ty[..., None] - r) ** 2 + (tx[..., None] - c) ** 2
            on_lane = (lane_flat[:, start:start + len(cell)] > 0)
            d2 = d2.masked_fill(~on_lane[:, None, None, :], float('inf'))
            best = torch.minimum(best, d2.amin(-1).to(dt))
        dist = torch.sqrt(best)
        pen = torch.where(dist > keep_distance, torch.zeros_like(dist),
                          (keep_distance - dist) ** 2)
        pen = torch.where(torch.isfinite(dist), pen, torch.zeros_like(pen))
        return pen * factor


def comfort_cost(trajs, factor: float, dt: float = 0.5,
                 c_lat_acc: float = 3.0, c_lon_acc: float = 3.0,
                 c_jerk: float = 1.0) -> torch.Tensor:
    """Lateral / longitudinal acceleration + jerk penalties
    (Comfort:307-370). Returns (B, N)."""
    vel = (trajs - _previous(trajs)) / dt            # (B, N, T, 2)
    acc = _diff_from_zero(vel) / dt
    acc = torch.cat([torch.zeros_like(acc[:, :, :1]), acc[:, :, 1:]], dim=2)
    lat_acc = acc[..., 0].abs().amax(-1)
    lon_acc = acc[..., 1].abs().amax(-1)

    speed = torch.sqrt((vel ** 2).sum(-1))
    ego_acc = _diff_from_zero(speed) / dt
    ego_acc = torch.cat([torch.zeros_like(ego_acc[:, :, :1]),
                         ego_acc[:, :, 1:]], dim=2)
    jerk = _diff_from_zero(ego_acc) / dt
    jerk = torch.cat([torch.zeros_like(jerk[:, :, :2]), jerk[:, :, 2:]],
                     dim=2)
    ego_jerk = jerk.abs().amax(-1)

    sub = ((lat_acc - c_lat_acc).clamp(0, 30) ** 2
           + (lon_acc - c_lon_acc).clamp(0, 30) ** 2
           + (ego_jerk - c_jerk).clamp(0, 20) ** 2)
    return sub * factor


def progress_cost(trajs, target_points, factor: float, pg=None
                  ) -> torch.Tensor:
    """Reward forward progress; penalise the distance to the goal when one
    is set (Progress:372-392). Returns (B, N).  Whether a goal is set is
    one flag over the whole batch; ``pg``: the process group whose ranks
    hold the rest of a data-parallel batch, over which it is taken."""
    fwd = trajs[..., 1].amax(-1)                      # (B, N)
    total = target_points.detach().abs().sum()
    if pg is not None:
        total = all_reduce_sum(total, pg)
    goal = ((trajs[:, :, -1] - target_points[:, None]) ** 2).sum(-1)
    sub2 = torch.where(total >= 0.5, goal, torch.zeros_like(goal))
    return (sub2 - fwd) * factor


def rule_cost(grid: CostGrid, trajs, drivable_area, factor: float = 5.0
              ) -> torch.Tensor:
    """Penalty for leaving the drivable area (Rule:173-198)."""
    drivable = _binary_channel(drivable_area)
    dangerous = (~(drivable > 0)).to(trajs.dtype)
    T = trajs.shape[2]
    dang = dangerous[:, None].expand(dangerous.shape[0], T,
                                     *dangerous.shape[1:])
    return compute_area(grid, dang, trajs) * factor


def costvolume_cost(grid: CostGrid, trajs, cost_volume, factor: float
                    ) -> torch.Tensor:
    """Sample the learned cost volume along each trajectory
    (Cost_Volume:157-171); its gradient adds into the sampled cells."""
    cv = cost_volume.clamp(0, 1000)                   # (B, T, H, W)
    yi, xi = discretize(grid, trajs)                  # (B, N, T)
    B, T, H, W = cv.shape
    idx = (yi * W + xi).permute(0, 2, 1)              # (B, T, N)
    vals = torch.gather(cv.reshape(B, T, H * W), 2, idx)
    return vals.permute(0, 2, 1) * factor             # (B, N, T)


def total_cost(grid: CostGrid, cfg_cost, cost_volume, trajs, semantic_pred,
               lane_divider, drivable_area, target_points, pg=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate the sub-costs (Cost_Function.forward:25-46).

    trajs arrive in ego (x, y); the x-flip to the raster convention happens
    here (reference :35).  ``pg``: see :func:`progress_cost`.  Returns
    (cost_fc (B, N), cost_fo (B, N, T))."""
    trajs = trajs * torch.tensor([-1.0, 1.0], dtype=trajs.dtype,
                                 device=trajs.device)

    def clip01(x):
        return x.clamp(0.0, 100.0)

    safety = clip01(safety_cost(grid, trajs, semantic_pred,
                                cfg_cost.LAMBDA, cfg_cost.SAFETY))
    headway = clip01(headway_cost(grid, trajs, semantic_pred, drivable_area,
                                  cfg_cost.HEADWAY))
    # the running minimum's type: JAX's default float, the model's float
    # type here (fp64 in an fp64 model, fp32 otherwise)
    lrdiv = clip01(lr_divider_cost(grid, trajs, lane_divider,
                                   cfg_cost.LRDIVIDER,
                                   dtype=_float(cost_volume)))
    comfort = clip01(comfort_cost(trajs, cfg_cost.COMFORT))
    progress = progress_cost(trajs, target_points, cfg_cost.PROGRESS,
                             pg).clamp(-100.0, 100.0)
    rule = clip01(rule_cost(grid, trajs, drivable_area))
    volume = clip01(costvolume_cost(grid, trajs, cost_volume,
                                    cfg_cost.VOLUME))

    cost_fo = safety + headway + lrdiv + volume + rule   # (B, N, T)
    cost_fc = comfort + progress                          # (B, N)
    return cost_fc, cost_fo
