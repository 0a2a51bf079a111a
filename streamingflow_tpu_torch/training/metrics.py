"""Evaluation metrics: IoU, panoptic quality (PQ/SQ/RQ) and planning.

Numpy port of streamingflow_tpu/training/metrics.py (reference
streamingflow/metrics.py: IntersectionOverUnion:15, PanopticMetric:74,
PlanningMetric:263): host-side states and updates, the same numbers.  Each
metric's ``state()`` is an array of counts and sums that adds across
processes (``load_state`` takes the sum back), as the sharded validation
sums them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class IntersectionOverUnion:
    """Stateful per-class IoU (reference metrics.py:15-71)."""

    def __init__(self, n_classes: int, ignore_index: Optional[int] = None,
                 absent_score: float = 0.0):
        self.n_classes = n_classes
        self.ignore_index = ignore_index
        self.absent_score = absent_score
        self.reset()

    def reset(self):
        z = np.zeros(self.n_classes, np.float64)
        self.true_positive = z.copy()
        self.false_positive = z.copy()
        self.false_negative = z.copy()
        self.support = z.copy()

    def update(self, prediction: np.ndarray, target: np.ndarray):
        prediction = np.asarray(prediction).reshape(-1)
        target = np.asarray(target).reshape(-1)
        for c in range(self.n_classes):
            p = prediction == c
            t = target == c
            self.true_positive[c] += np.sum(p & t)
            self.false_positive[c] += np.sum(p & ~t)
            self.false_negative[c] += np.sum(~p & t)
            self.support[c] += np.sum(t)

    def state(self) -> np.ndarray:
        return np.stack([self.true_positive, self.false_positive,
                         self.false_negative, self.support])

    def load_state(self, state: np.ndarray):
        (self.true_positive, self.false_positive, self.false_negative,
         self.support) = [s.copy() for s in state]

    def compute(self) -> np.ndarray:
        scores = np.zeros(self.n_classes, np.float32)
        for c in range(self.n_classes):
            if c == self.ignore_index:
                continue
            tp, fp, fn = (self.true_positive[c], self.false_positive[c],
                          self.false_negative[c])
            if self.support[c] + tp + fp == 0:
                scores[c] = self.absent_score
                continue
            scores[c] = tp / max(tp + fp + fn, 1e-12)
        if self.ignore_index is not None and 0 <= self.ignore_index < self.n_classes:
            scores = np.concatenate([scores[:self.ignore_index],
                                     scores[self.ignore_index + 1:]])
        return scores


class PanopticMetric:
    """Video panoptic quality with temporal-consistency penalty.

    Reference: metrics.py:74-261 (bincount confusion :174-184, IoU>0.5
    matching, temporal id-consistency false pairs :201-207)."""

    def __init__(self, n_classes: int, temporally_consistent: bool = True,
                 vehicles_id: int = 1):
        self.n_classes = n_classes
        self.temporally_consistent = temporally_consistent
        self.vehicles_id = vehicles_id
        self.reset()

    def reset(self):
        z = np.zeros(self.n_classes, np.float64)
        self.iou = z.copy()
        self.true_positive = z.copy()
        self.false_positive = z.copy()
        self.false_negative = z.copy()

    def state(self) -> np.ndarray:
        return np.stack([self.iou, self.true_positive, self.false_positive,
                         self.false_negative])

    def load_state(self, state: np.ndarray):
        self.iou, self.true_positive, self.false_positive, \
            self.false_negative = [s.copy() for s in state]

    def update(self, pred_instance: np.ndarray, gt_instance: np.ndarray):
        """pred_instance / gt_instance: (B, S, H, W) int instance ids
        (0 = background), ids temporally consistent within a sequence."""
        pred_instance = np.asarray(pred_instance)
        gt_instance = np.asarray(gt_instance)
        assert gt_instance.min() == 0, 'ID 0 of gt_instance must be background'
        B, S = gt_instance.shape[:2]
        for b in range(B):
            unique_id_mapping: Dict[int, int] = {}
            for t in range(S):
                self._panoptic_single(
                    (pred_instance[b, t] > 0).astype(np.int64),
                    pred_instance[b, t],
                    (gt_instance[b, t] > 0).astype(np.int64),
                    gt_instance[b, t], unique_id_mapping)

    def _combine_mask(self, segmentation, instance, n_classes, n_all_things):
        """Shift instance ids above class ids; build id->class index."""
        instance = instance.reshape(-1)
        instance_mask = instance > 0
        instance = instance - 1 + n_classes
        segmentation = segmentation.reshape(-1).copy()
        segmentation_mask = segmentation < n_classes

        id_to_class = -np.ones(n_all_things, np.int64)
        sel = instance_mask & segmentation_mask
        id_to_class[instance[sel]] = segmentation[sel]
        id_to_class[:n_classes] = np.arange(n_classes)

        segmentation[instance_mask] = instance[instance_mask]
        segmentation += 1
        segmentation[~segmentation_mask] = 0
        return segmentation, id_to_class

    def _panoptic_single(self, pred_seg, pred_inst, gt_seg, gt_inst,
                         unique_id_mapping):
        n_classes = self.n_classes
        n_instances = int(max(pred_inst.max(), gt_inst.max()))
        n_all_things = n_instances + n_classes
        n_things_and_void = n_all_things + 1

        prediction, pred_to_cls = self._combine_mask(
            pred_seg, pred_inst, n_classes, n_all_things)
        target, target_to_cls = self._combine_mask(
            gt_seg, gt_inst, n_classes, n_all_things)

        x = prediction + n_things_and_void * target
        conf = np.bincount(x, minlength=n_things_and_void ** 2).reshape(
            n_things_and_void, n_things_and_void)[1:, 1:]
        union = conf.sum(0)[None] + conf.sum(1)[:, None] - conf
        iou = np.where(union > 0, (conf + 1e-9) / (union + 1e-9), 0.0)

        mapping = np.argwhere(iou > 0.5)  # (pairs, [target, pred])
        if len(mapping):
            is_matching = (pred_to_cls[mapping[:, 1]]
                           == target_to_cls[mapping[:, 0]])
            mapping = mapping[is_matching]
        tp_mask = np.zeros_like(conf, bool)
        if len(mapping):
            tp_mask[mapping[:, 0], mapping[:, 1]] = True

        for target_id, pred_id in mapping:
            cls_id = pred_to_cls[pred_id]
            if (self.temporally_consistent and cls_id == self.vehicles_id
                    and target_id in unique_id_mapping
                    and unique_id_mapping[target_id] != pred_id):
                # temporally inconsistent id switch (reference :201-207)
                self.false_negative[target_to_cls[target_id]] += 1
                self.false_positive[pred_to_cls[pred_id]] += 1
                unique_id_mapping[target_id] = pred_id
                continue
            self.true_positive[cls_id] += 1
            self.iou[cls_id] += iou[target_id, pred_id]
            unique_id_mapping[target_id] = pred_id

        for target_id in range(n_classes, n_all_things):
            if tp_mask[target_id, n_classes:].any():
                continue
            if target_to_cls[target_id] != -1:
                self.false_negative[target_to_cls[target_id]] += 1

        for pred_id in range(n_classes, n_all_things):
            if tp_mask[n_classes:, pred_id].any():
                continue
            if pred_to_cls[pred_id] != -1 and (conf[:, pred_id] > 0).any():
                self.false_positive[pred_to_cls[pred_id]] += 1

    def compute(self) -> Dict[str, np.ndarray]:
        denominator = np.maximum(
            self.true_positive + self.false_positive / 2
            + self.false_negative / 2, 1.0)
        return {
            'pq': self.iou / denominator,
            'sq': self.iou / np.maximum(self.true_positive, 1.0),
            'rq': self.true_positive / denominator,
        }


class PlanningMetric:
    """L2 error and object / ego-box collision counts of planned
    trajectories against BEV occupancy, per future step (reference
    metrics.py:263-396).  The ego box is rasterised by the cost library's
    half-plane fill (ops/cost.py::polygon_fill) where the JAX metric takes
    matplotlib's ``Path.contains_points``: the same cells at the tiny and
    the flagship grids (tests/test_torch_planning_metric.py)."""

    def __init__(self, cfg, n_future: int = 4):
        from .. import geometry as G
        dx, start, dim = G.calculate_birds_eye_view_parameters(
            cfg.LIFT.X_BOUND, cfg.LIFT.Y_BOUND, cfg.LIFT.Z_BOUND)
        self.dx = dx[:2]
        self.bx = start[:2]
        self.bev_dimension = dim
        self.W = cfg.EGO.WIDTH
        self.H = cfg.EGO.HEIGHT
        self.n_future = n_future
        self.reset()

    def reset(self):
        self.obj_col = np.zeros(self.n_future, np.float64)
        self.obj_box_col = np.zeros(self.n_future, np.float64)
        self.L2 = np.zeros(self.n_future, np.float64)
        self.total = 0

    def state(self) -> np.ndarray:
        return np.concatenate([self.obj_col, self.obj_box_col, self.L2,
                               [self.total]])

    def load_state(self, state: np.ndarray):
        state = np.asarray(state, np.float64)
        n = self.n_future
        self.obj_col = state[:n].copy()
        self.obj_box_col = state[n:2 * n].copy()
        self.L2 = state[2 * n:3 * n].copy()
        self.total = int(round(float(state[3 * n])))

    def ego_box_cells(self) -> np.ndarray:
        """(K, 2) integer (row, col) cells of the ego box around the
        origin."""
        from ..ops.cost import ego_box_points, polygon_fill
        return polygon_fill(ego_box_points(self.bx, self.dx, self.W, self.H))

    def _single_coll(self, traj, segmentation):
        rc = self.ego_box_cells()
        n_future = traj.shape[0]
        trajs = traj.reshape(n_future, 1, 2)[:, :, ::-1] / self.dx
        trajs = trajs + rc
        r = np.clip(trajs[:, :, 0].astype(np.int32), 0,
                    self.bev_dimension[0] - 1)
        c = np.clip(trajs[:, :, 1].astype(np.int32), 0,
                    self.bev_dimension[1] - 1)
        collision = np.zeros(n_future, bool)
        for t in range(n_future):
            collision[t] = bool(np.any(segmentation[t, r[t], c[t]]))
        return collision

    def update(self, trajs: np.ndarray, gt_trajs: np.ndarray,
               segmentation: np.ndarray):
        """trajs / gt_trajs (B, n_future, 3); segmentation (B, n_future, H,
        W)."""
        trajs = np.asarray(trajs)
        gt_trajs = np.asarray(gt_trajs)
        segmentation = np.asarray(segmentation)
        self.L2 += np.sqrt(((trajs[:, :, :2] - gt_trajs[:, :, :2]) ** 2
                            ).sum(-1)).sum(0)
        B, n_future = trajs.shape[:2]
        flip = np.array([-1, 1])
        t2 = trajs[:, :, :2] * flip
        g2 = gt_trajs[:, :, :2] * flip
        for i in range(B):
            gt_box_coll = self._single_coll(g2[i], segmentation[i])
            # row index from the y-component, column from x (ref :349-351)
            xx, yy = t2[i, :, 0], t2[i, :, 1]
            yi = ((yy - self.bx[0]) / self.dx[0]).astype(np.int64)
            xi = ((xx - self.bx[1]) / self.dx[1]).astype(np.int64)
            m1 = ((yi >= 0) & (yi < self.bev_dimension[0])
                  & (xi >= 0) & (xi < self.bev_dimension[1])
                  & ~gt_box_coll)
            ti = np.arange(n_future)
            self.obj_col[ti[m1]] += segmentation[i, ti[m1], yi[m1], xi[m1]]
            m2 = ~gt_box_coll
            box_coll = self._single_coll(t2[i], segmentation[i])
            self.obj_box_col[ti[m2]] += box_coll[ti[m2]]
        self.total += B

    def compute(self) -> Dict[str, np.ndarray]:
        total = max(self.total, 1)
        return {'obj_col': self.obj_col / total,
                'obj_box_col': self.obj_box_col / total,
                'L2': self.L2 / total}


def metric_states(**metrics) -> Dict[str, list]:
    """Each metric's state as nested lists, by name (None skipped): the
    counts behind IoU (true and false positives, false negatives, support)
    and PQ (IoU sum, true and false positives, false negatives), which
    count every label even where the score is 0."""
    return {k: m.state().tolist() for k, m in metrics.items()
            if m is not None}
