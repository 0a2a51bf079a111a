"""The port's instance post-processing, IoU and PQ against the JAX
package's, exactly, on seeded random outputs (blobs of vehicles moving
across frames, with noisy heatmaps, offsets and flows)."""
import numpy as np
import pytest

from streamingflow_tpu import postprocess as JP
from streamingflow_tpu.training import metrics as JM
from streamingflow_tpu_torch import postprocess as PP
from streamingflow_tpu_torch.training import metrics as PM


def _outputs(seed, b=2, t=5, h=40, w=48, n=6):
    """Model-like outputs: n vehicles as blobs drifting across t frames."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing='ij')
    seg = rng.randn(b, t, h, w, 2).astype(np.float32) * 0.3
    center = np.zeros((b, t, h, w, 1), np.float32)
    offset = rng.randn(b, t, h, w, 2).astype(np.float32) * 0.4
    flow = rng.randn(b, t, h, w, 2).astype(np.float32) * 0.5
    gt = np.zeros((b, t, h, w), np.int64)
    for bi in range(b):
        pos = rng.uniform([4, 4], [h - 4, w - 4], size=(n, 2))
        vel = rng.uniform(-2, 2, size=(n, 2))
        for ti in range(t):
            for k, (cy, cx) in enumerate(pos + ti * vel):
                r = rng.uniform(2, 4)
                d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                blob = d2 < r * r
                seg[bi, ti][blob, 1] += 2.0
                center[bi, ti, ..., 0] = np.maximum(
                    center[bi, ti, ..., 0], np.exp(-d2 / 4.0))
                offset[bi, ti][blob, 0] += cy - yy[blob]
                offset[bi, ti][blob, 1] += cx - xx[blob]
                flow[bi, ti][blob] += vel[k]
                gt[bi, ti][blob] = k + 1
    return {'segmentation': seg, 'instance_center': center,
            'instance_offset': offset, 'instance_flow': flow}, gt


@pytest.mark.parametrize('short_interval', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_postprocess_and_metrics_equal_the_jax_modules(seed, short_interval):
    out, gt = _outputs(seed)
    want = JP.predict_instance_segmentation_and_trajectories(
        out, short_interval=short_interval)
    got = PP.predict_instance_segmentation_and_trajectories(
        out, short_interval=short_interval)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3

    seg_pred = np.argmax(out['segmentation'], axis=-1)
    for j, p in ((JM.IntersectionOverUnion(2), PM.IntersectionOverUnion(2)),
                 (JM.IntersectionOverUnion(2, ignore_index=0),
                  PM.IntersectionOverUnion(2, ignore_index=0))):
        j.update(seg_pred, gt > 0)
        p.update(seg_pred, gt > 0)
        np.testing.assert_array_equal(p.compute(), j.compute())
        np.testing.assert_array_equal(p.state(), j.state())

    for consistent in (True, False):
        j = JM.PanopticMetric(2, temporally_consistent=consistent)
        p = PM.PanopticMetric(2, temporally_consistent=consistent)
        j.update(want, gt)
        p.update(got, gt)
        jr, pr = j.compute(), p.compute()
        assert jr.keys() == pr.keys() == {'pq', 'sq', 'rq'}
        for k in jr:
            np.testing.assert_array_equal(pr[k], jr[k])
        np.testing.assert_array_equal(p.state(), j.state())
        assert float(j.true_positive[1]) > 0


def test_matched_centers_equal_the_jax_module():
    out, _ = _outputs(3, b=1)
    jc, jm = JP.predict_instance_segmentation_and_trajectories(
        out, compute_matched_centers=True)
    pc, pm = PP.predict_instance_segmentation_and_trajectories(
        out, compute_matched_centers=True)
    np.testing.assert_array_equal(pc, jc)
    assert pm.keys() == jm.keys() and jm
    for k in jm:
        np.testing.assert_array_equal(pm[k], jm[k])
