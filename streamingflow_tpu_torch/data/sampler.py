"""Candidate trajectory sampler: straight lines, circular arcs, clothoids.

A copy of streamingflow_tpu/data/sampler.py, kept in the port so that it
imports nothing of the JAX package.

Re-implementation of reference streamingflow/utils/sampler.py:8-146 — sample
M kinematically-plausible (x, y, theta) rollouts from the current speed and
steering curvature for the planning head's cost selection.
"""
from __future__ import annotations

import numpy as np
from scipy.special import fresnel


def _sample_core(v0: float, kappa: float, T0: np.ndarray, N0: np.ndarray,
                 tt: np.ndarray, M: int, possibility=None,
                 rng: np.random.RandomState = None) -> np.ndarray:
    rng = rng or np.random
    if possibility is None:
        possibility = [0.4, 0.2, 0.4]
    straight_num = int(M * possibility[1])
    left_num = int(M * possibility[0])
    right_num = int(M * possibility[2])

    # accelerations in [-3, 7] m/s^2; velocities 80% current, 20% random <=15
    accelerations = 10 * (rng.rand(M) - 0.5) + 2
    v_options = np.stack((np.full(M, v0), 15 * rng.rand(M)))
    v_sel = (rng.rand(M) >= 0.2).astype(int)
    velocities = v_options[v_sel, np.arange(M)]

    L = velocities[:, None] * tt[None] + accelerations[:, None] * tt[None] ** 2 / 2
    L_straight, L = L[:straight_num], L[straight_num:]
    alphas = (80 - 6) * rng.rand(left_num + right_num) + 6

    # straight lines
    line_points = L_straight[:, :, None] * T0[None, None]
    lines = np.concatenate(
        [line_points, np.zeros_like(L_straight)[:, :, None]], axis=-1)

    # circular arcs at the current curvature
    k = min(-0.01, kappa) if kappa <= 0 else max(0.01, kappa)
    radius = abs(1 / k)
    center = np.array([-1 / k, 0])
    phis = L / radius if k >= 0 else np.pi - L / radius
    circle_points = np.dstack([center[0] + radius * np.cos(phis),
                               center[1] + radius * np.sin(phis)])
    circle_thetas = L / radius if k >= 0 else -L / radius
    circle_thetas = (circle_thetas + np.pi) % (2 * np.pi) - np.pi
    circles = np.concatenate([circle_points, circle_thetas[:, :, None]], -1)

    # clothoid spirals
    xi0 = abs(kappa) / np.pi
    xis = xi0 + L
    Ss, Cs = fresnel(xis / alphas[:, None])
    cl_pts = alphas[:, None, None] * (Cs[:, :, None] * T0[None, None]
                                      + Ss[:, :, None] * N0[None, None])
    Xs = cl_pts[:, :, 0] - cl_pts[:, 0, 0, None]
    Ys = cl_pts[:, :, 1] - cl_pts[:, 0, 1, None]
    theta0 = 0.5 * np.pi * ((kappa / np.pi / alphas) ** 2)[:, None]
    s_theta0 = theta0 * np.sign(kappa)
    cl_pts[:, :, 0] = np.cos(s_theta0) * Xs + np.sin(s_theta0) * Ys
    cl_pts[:, :, 1] = -np.sin(s_theta0) * Xs + np.cos(s_theta0) * Ys
    cl_thetas = 0.5 * np.pi * (xis / alphas[:, None]) ** 2 - theta0
    s_cl_thetas = cl_thetas * np.sign(kappa)
    s_cl_thetas = (s_cl_thetas + np.pi) % (2 * np.pi) - np.pi
    clothoids = np.concatenate([cl_pts, s_cl_thetas[:, :, None]], -1)

    # 80% clothoid / 20% circle for the curved candidates
    t_options = np.stack((circles, clothoids))
    t_sel = rng.choice([0, 1], size=left_num + right_num, p=(0.2, 0.8))
    trajs = t_options[t_sel, np.arange(left_num + right_num)]

    def flip(x):
        return np.dstack((-x[:, :, 0], x[:, :, 1], -x[:, :, 2]))

    if kappa > 0:
        left_curve = trajs[:left_num]
        right_curve = flip(trajs[left_num:left_num + right_num])
    else:
        right_curve = trajs[:left_num]
        left_curve = flip(trajs[left_num:left_num + right_num])

    out = np.concatenate([left_curve, lines, right_curve], axis=0)
    return out[np.argsort(out[:, -1, 0])]


def sample(v0: float, kappa: float, n_samples: int, t_end: float,
           n_future: int, sample_interval: float = 0.5,
           rng=None) -> np.ndarray:
    """Sample trajectories on a fine grid, then subsample to keyframes.

    Returns (n_samples, n_future + 1, 3) — matches the dataset's usage
    (reference NuscenesData.py:545-551)."""
    T0 = np.array([0.0, 1.0])
    N0 = np.array([1.0, 0.0]) if kappa <= 0 else np.array([-1.0, 0.0])
    t_interval = sample_interval / 10
    tt = np.arange(0, t_end + t_interval, t_interval)
    fine = _sample_core(v0, kappa, T0, N0, tt, n_samples, rng=rng)
    return fine[:, ::10]
