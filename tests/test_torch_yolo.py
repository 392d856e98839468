"""The port's ``Yolo2OutputLayer``, ``iou`` and ``get_predicted_objects``
against the JAX package's, on the CPU.

The loss and its gradient with respect to the network output on random
outputs and labels (boxes in grid units, one-hot classes, empty cells),
an IoU tie (two identical anchors give identical predictions: both
packages take the first box as responsible), and the decode + threshold
+ NMS on a fixed output. Bounds: the loss within 1e-5 relative and its
gradient within 1e-4 relative L2 (the same f32 math summed in other
orders); the detections equal field for field within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import objdetect as jod
from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch.models.serialization import _ensure_registry
from deeplearning4j_tpu_torch.nn.layers import objdetect as tod
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.utils import serde as tserde

_ensure_registry()

VOC = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
       (7.88282, 3.52778), (9.77052, 9.16828))


def _layers(boxes=VOC, **kw):
    jl = jod.Yolo2OutputLayer(boxes=boxes, **kw)
    js = jserde.to_json(jl)
    tl = tserde.from_json(js)
    assert isinstance(tl, tod.Yolo2OutputLayer)
    assert tserde.to_json(tl) == js
    return jl, tl


def _labels(rng, n, h, w, c, empty=0.3):
    y = np.zeros((n, h, w, 4 + c), np.float32)
    y[..., 0] = rng.uniform(0, w, (n, h, w))
    y[..., 1] = rng.uniform(0, h, (n, h, w))
    y[..., 2:4] = rng.uniform(0.3, 4.0, (n, h, w, 2))
    y[..., 4:] = np.eye(c, dtype=np.float32)[rng.integers(0, c, (n, h, w))]
    y[rng.uniform(size=(n, h, w)) < empty, 4:] = 0.0   # cells with no object
    y[0, 0, 0, 4:] = 0.0
    return y


def _loss_and_grad(jl, tl, x, y):
    lj, gj = jax.value_and_grad(lambda xx: jl.compute_loss(
        {}, {}, xx, jnp.asarray(y), JCtx()))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    lt = tl.compute_loss({}, {}, tx, torch.from_numpy(y), LayerContext())
    (gt,) = torch.autograd.grad(lt, tx)
    return float(lj), np.asarray(gj), lt.item(), gt.numpy()


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("classes,hw,kw", [
    (20, (4, 5), {}),
    (3, (2, 2), dict(lambda_coord=1.0, lambda_no_obj=2.0)),
    (1, (3, 3), {}),
])
def test_loss_and_gradient_match_jax(classes, hw, kw):
    rng = np.random.default_rng(0)
    jl, tl = _layers(**kw)
    n = 3
    x = rng.normal(0, 1, (n,) + hw + (len(VOC) * (5 + classes),)).astype(
        np.float32)
    y = _labels(rng, n, *hw, classes)
    lj, gj, lt, gt = _loss_and_grad(jl, tl, x, y)
    assert lt == pytest.approx(lj, rel=1e-5)
    assert _rel_l2(gt, gj) <= 1e-4
    # the layer passes the activations through unchanged
    out, _ = tl.apply({}, {}, torch.from_numpy(x), LayerContext())
    assert torch.equal(out, torch.from_numpy(x))


def test_iou_tie_takes_the_first_box_and_empty_cells_have_no_object_terms():
    """Two identical anchors with identical predictions tie on IoU: both
    packages make box 0 responsible, so box 1's coordinates get no
    gradient and its confidence is pushed to 0. An empty cell contributes
    only the no-object confidence term."""
    rng = np.random.default_rng(1)
    jl, tl = _layers(boxes=((1.5, 1.5), (1.5, 1.5)))
    c, n = 2, 2
    one = rng.normal(0, 1, (n, 2, 2, 5 + c)).astype(np.float32)
    x = np.concatenate([one, one], axis=-1)            # box 1 == box 0
    y = _labels(rng, n, 2, 2, c, empty=0.0)
    y[1, 1, 1, 4:] = 0.0                                # an empty cell
    lj, gj, lt, gt = _loss_and_grad(jl, tl, x, y)
    assert lt == pytest.approx(lj, rel=1e-5)
    assert _rel_l2(gt, gj) <= 1e-4
    g = gt.reshape(n, 2, 2, 2, 5 + c)
    obj = y[..., 4:].sum(-1) > 0
    # box 1 of an object cell: coordinates and classes get no gradient
    assert np.all(g[obj][:, 1, [0, 1, 2, 3]] == 0.0)
    assert np.all(g[obj][:, 1, 5:] == 0.0)
    assert np.all(g[obj][:, 0, :4] != 0.0)
    # an empty cell: only the confidence logits move
    assert np.all(g[1, 1, 1][:, [0, 1, 2, 3]] == 0.0)
    assert np.all(g[1, 1, 1][:, 5:] == 0.0)
    assert np.all(g[1, 1, 1][:, 4] != 0.0)


def test_loss_is_divided_by_the_batch():
    rng = np.random.default_rng(2)
    _, tl = _layers()
    x = torch.from_numpy(rng.normal(0, 1, (1, 2, 2, 5 * 8)).astype(
        np.float32))
    y = torch.from_numpy(_labels(rng, 1, 2, 2, 3))
    one = tl.compute_loss({}, {}, x, y, LayerContext())
    two = tl.compute_loss({}, {}, torch.cat([x, x]), torch.cat([y, y]),
                          LayerContext())
    torch.testing.assert_close(two, one)


def _fixed_output(rng, n=2, h=4, w=4, classes=3):
    x = rng.normal(0, 1.5, (n, h, w, len(VOC), 5 + classes)).astype(
        np.float32)
    x[..., 4] -= 1.0
    # two overlapping confident boxes of one class in one cell: NMS keeps one
    x[0, 1, 1, 1, :5] = [0.0, 0.0, 0.0, 0.0, 5.0]
    x[0, 1, 1, 2, :5] = [0.1, 0.0, -0.6, -1.0, 4.0]
    x[0, 1, 1, 1, 5:] = x[0, 1, 1, 2, 5:] = [4.0, 0.0, 0.0]
    return x.reshape(n, h, w, -1)


@pytest.mark.parametrize("threshold,nms", [(0.5, 0.4), (0.3, None),
                                           (0.2, 0.1)])
def test_get_predicted_objects_matches_jax(threshold, nms):
    rng = np.random.default_rng(3)
    jl, tl = _layers()
    out = _fixed_output(rng)
    dj = jod.get_predicted_objects(jl, out, threshold, nms)
    dt = tod.get_predicted_objects(tl, torch.from_numpy(out), threshold,
                                   nms)
    assert len(dt) == len(dj) > 0
    for a, b in zip(dt, dj):
        assert (a.example, a.predicted_class) == (b.example,
                                                  b.predicted_class)
        np.testing.assert_allclose(
            [a.center_x, a.center_y, a.width, a.height, a.confidence],
            [b.center_x, b.center_y, b.width, b.height, b.confidence],
            rtol=1e-5, atol=1e-6)
        assert tod.iou(a, a) == pytest.approx(1.0)
    if nms is not None:
        for i, a in enumerate(dt):
            for b in dt[:i]:
                if (a.example, a.predicted_class) == (b.example,
                                                      b.predicted_class):
                    assert tod.iou(a, b) <= nms


def test_iou_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        v = rng.uniform(0, 4, 8)
        a = (0, v[0], v[1], v[2] + 0.1, v[3] + 0.1, 0, 0.9)
        b = (0, v[4], v[5], v[6] + 0.1, v[7] + 0.1, 0, 0.8)
        assert tod.iou(tod.DetectedObject(*a), tod.DetectedObject(*b)) == \
            pytest.approx(jod.iou(jod.DetectedObject(*a),
                                  jod.DetectedObject(*b)))
