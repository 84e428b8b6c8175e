"""The port's YOLOv2 output layer and its post-processing against the JAX
package (CPU).

Preds and labels come from numpy with a seed: raw network outputs for 5
anchors and 4 classes on a 4x5 grid, labels with objects in some cells
and the rest empty (and a batch with no object at all).

Tolerances: the activated output and the loss 1e-5 (fp32, the same
arithmetic); the loss gradient with respect to the raw output against
``jax.grad`` 2e-4 of its largest element (the reference's gradient
tolerance). ``getPredictedObjects`` + ``nms`` must return the same
objects, in the same order, with coordinates and scores within 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import objdetect as jod
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu_torch.nn import objdetect as tod
from deeplearning4j_tpu_torch.nn.config import InputType

torch.set_num_threads(2)

ANCHORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11],
           [16.62, 10.52]]
B, C, H, W = 5, 4, 4, 5
TOL = 1e-5
GRAD_TOL = 2e-4


def _layers():
    j = jod.Yolo2OutputLayer(boundingBoxPriors=ANCHORS)
    t = tod.Yolo2OutputLayer(boundingBoxPriors=ANCHORS)
    j.infer_nin(JInputType.convolutional(H, W, B * (5 + C)))
    t.infer_nin(InputType.convolutional(H, W, B * (5 + C)))
    return j, t


def _raw(seed, n=3):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, B * (5 + C), H, W)) * 1.5
            ).astype(np.float32)


def _labels(seed, n=3, empty=False):
    """Boxes (in grid units) at their centre's cell, one-hot classes;
    cells without an object all zero."""
    r = np.random.default_rng(seed)
    y = np.zeros((n, 4 + C, H, W), np.float32)
    if empty:
        return y
    for i in range(n):
        for _ in range(1 + i):
            cx, cy = r.uniform(0, W), r.uniform(0, H)
            bw, bh = r.uniform(0.3, 4.0), r.uniform(0.3, 4.0)
            gx, gy = int(cx), int(cy)
            y[i, :4, gy, gx] = [cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                cy + bh / 2]
            y[i, 4:, gy, gx] = 0
            y[i, 4 + r.integers(0, C), gy, gx] = 1
    return y


def test_infer_nin_as_jax():
    j, t = _layers()
    assert (t.nIn, t.nOut, t._n_classes, t._grid_h, t._grid_w) == \
        (j.nIn, j.nOut, j._n_classes, j._grid_h, j._grid_w)
    with pytest.raises(ValueError, match="not divisible"):
        t.infer_nin(InputType.convolutional(H, W, 7))


def test_apply_matches_jax():
    j, t = _layers()
    x = _raw(0)
    want, _ = j.apply({}, {}, jnp.asarray(x), False, jax.random.PRNGKey(0))
    got, _ = t.apply({}, {}, torch.from_numpy(x), False)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("empty", [False, True])
def test_loss_and_gradient_match_jax(empty):
    j, t = _layers()
    x, y = _raw(1), _labels(2, empty=empty)

    def jloss(raw):
        p, _ = j.apply({}, {}, raw, True, jax.random.PRNGKey(0))
        return j.compute_loss(jnp.asarray(y), p)

    want, gwant = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    p, _ = t.apply({}, {}, xt, True)
    got = t.compute_loss(torch.from_numpy(y), p)
    (g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)
    gwant = np.asarray(gwant)
    np.testing.assert_allclose(g.numpy(), gwant, rtol=0,
                               atol=GRAD_TOL * np.abs(gwant).max())


def test_responsible_anchor_ties_take_the_first():
    # a box whose shape matches two anchors' IoU equally: jnp.argmax and
    # torch.argmax both take the first, so both losses pick anchor 0
    j = jod.Yolo2OutputLayer(boundingBoxPriors=[[1.0, 2.0], [2.0, 1.0]])
    t = tod.Yolo2OutputLayer(boundingBoxPriors=[[1.0, 2.0], [2.0, 1.0]])
    x = _raw(3, n=1)[:, :2 * (5 + C)]
    y = np.zeros((1, 4 + C, H, W), np.float32)
    y[0, :4, 1, 1] = [1.0, 1.0, 2.5, 2.5]          # 1.5 x 1.5: a tie
    y[0, 4 + 2, 1, 1] = 1
    pj, _ = j.apply({}, {}, jnp.asarray(x), True, jax.random.PRNGKey(0))
    pt, _ = t.apply({}, {}, torch.from_numpy(x), True)
    np.testing.assert_allclose(
        float(t.compute_loss(torch.from_numpy(y), pt)),
        float(j.compute_loss(jnp.asarray(y), pj)), rtol=TOL, atol=TOL)


def test_predicted_objects_and_nms_match_jax():
    j, t = _layers()
    x = _raw(4, n=4) * 1.3
    out, _ = j.apply({}, {}, jnp.asarray(x), False, jax.random.PRNGKey(0))
    out = np.asarray(out)
    for conf, nms in ((0.5, 0.4), (0.2, 0.3), (0.05, 0.5)):
        want = jod.YoloUtils.getPredictedObjects(ANCHORS, out, conf, nms)
        got = tod.YoloUtils.getPredictedObjects(
            ANCHORS, torch.from_numpy(out), conf, nms)
        assert len(got) == len(want) and len(want) > 0
        for a, b in zip(got, want):
            assert (a.example, a.predicted_class) == \
                (b.example, b.predicted_class)
            np.testing.assert_allclose(
                [a.center_x, a.center_y, a.width, a.height, a.confidence],
                [b.center_x, b.center_y, b.width, b.height, b.confidence],
                rtol=TOL, atol=TOL)
    objs = [tod.DetectedObject(0, 1.0, 1.0, 2.0, 2.0, 1, 0.9),
            tod.DetectedObject(0, 1.2, 1.1, 2.0, 2.0, 1, 0.8),
            tod.DetectedObject(0, 1.2, 1.1, 2.0, 2.0, 0, 0.7),
            tod.DetectedObject(0, 5.0, 5.0, 1.0, 1.0, 1, 0.6)]
    jobjs = [jod.DetectedObject(o.example, o.center_x, o.center_y, o.width,
                                o.height, o.predicted_class, o.confidence)
             for o in objs]
    kept = tod.YoloUtils.nms(objs, 0.4)
    assert [o.confidence for o in kept] == \
        [o.confidence for o in jod.YoloUtils.nms(jobjs, 0.4)] == \
        [0.9, 0.6, 0.7]
    assert tod.YoloUtils.iou(objs[0], objs[1]) == \
        pytest.approx(jod.YoloUtils.iou(jobjs[0], jobjs[1]))


def test_yolo_labels_give_the_loss_one_to_three_boxes_an_image():
    y = tod.yolo_labels(np.random.default_rng(0), 6, C, grid=W)
    assert y.shape == (6, 4 + C, W, W) and y.dtype == np.float32
    occupied = y[:, 4:].sum(1) > 0
    assert set(occupied.reshape(6, -1).sum(1)) <= {1, 2, 3}
    assert np.all(y[:, 4:].sum(1)[occupied] == 1.0)
    gy, gx = np.nonzero(occupied)[1:]
    cx = (y[:, 0] + y[:, 2])[occupied] / 2
    cy = (y[:, 1] + y[:, 3])[occupied] / 2
    assert np.all(np.floor(cx) == gx) and np.all(np.floor(cy) == gy)
    # the loss on the first H rows of the grid, against JAX
    j, t = _layers()
    y, x = y[:, :, :H, :W], _raw(6, n=6)
    want = float(j.compute_loss(jnp.asarray(y), jnp.asarray(x)))
    got = float(t.compute_loss(torch.from_numpy(y), torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=TOL)
