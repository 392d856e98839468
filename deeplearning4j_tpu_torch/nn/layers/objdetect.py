"""YOLOv2 output layer and detection utilities.

The JAX package's ``nn/layers/objdetect.py`` (reference: nn/layers/
objdetect/Yolo2OutputLayer.java, YoloUtils.java, DetectedObject.java).

Layout (NHWC): the network output is (N, H, W, B·(5 + C)) for B anchor
boxes and C classes, per box [tx, ty, tw, th, to, class logits...].
Labels are (N, H, W, 4 + C): [cx, cy, w, h] in grid units and a one-hot
class; a cell whose class vector is all zero holds no object. The loss
(IoU responsibility, coordinate, confidence and class terms) is plain
torch and differentiates through ``torch.autograd``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, LayerContext
from deeplearning4j_tpu_torch.utils.serde import register_serializable


@register_serializable
@dataclasses.dataclass(frozen=True)
class Yolo2OutputLayer(Layer):
    """Loss-only layer (no parameters); ``boxes`` = ((w, h), ...) anchor
    priors in grid units."""
    boxes: Tuple = ((1.0, 1.0),)
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    @property
    def has_params(self) -> bool:
        return False

    @property
    def num_boxes(self) -> int:
        return len(self.boxes)

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _split(self, y):
        """(N,H,W,B·(5+C)) → tx, ty, tw, th, confidence logit, class
        logits."""
        n, h, w, d = y.shape
        b = self.num_boxes
        y = y.reshape(n, h, w, b, d // b)
        return (y[..., 0], y[..., 1], y[..., 2], y[..., 3], y[..., 4],
                y[..., 5:])

    def _anchors(self, y):
        return torch.tensor([list(map(float, wh)) for wh in self.boxes],
                            dtype=y.dtype, device=y.device)   # (B, 2)

    def _decode(self, y):
        """Activated predictions: center and size (grid units),
        confidence, class probabilities."""
        tx, ty, tw, th, to, tc = self._split(y)
        n, h, w = tx.shape[:3]
        gx = torch.arange(w, dtype=y.dtype, device=y.device)[None, None, :,
                                                              None]
        gy = torch.arange(h, dtype=y.dtype, device=y.device)[None, :, None,
                                                              None]
        anchors = self._anchors(y)
        cx = torch.sigmoid(tx) + gx
        cy = torch.sigmoid(ty) + gy
        bw = anchors[:, 0] * torch.exp(tw)
        bh = anchors[:, 1] * torch.exp(th)
        return (cx, cy, bw, bh, torch.sigmoid(to),
                torch.softmax(tc, dim=-1))

    def apply(self, params, state, x, ctx: LayerContext):
        return x, state      # the raw activations pass through

    def compute_loss(self, params, state, x, labels, ctx: LayerContext):
        f32 = torch.float32
        x = x.to(f32)
        labels = labels.to(f32)
        tx, ty, tw, th, to, tc = self._split(x)
        n, h, w, b = tx.shape
        g_cx, g_cy = labels[..., 0], labels[..., 1]            # (N,H,W)
        g_w = torch.clamp(labels[..., 2], min=1e-6)
        g_h = torch.clamp(labels[..., 3], min=1e-6)
        g_cls = labels[..., 4:]                                # (N,H,W,C)
        obj_mask = (g_cls.sum(-1) > 0).to(f32)

        cx, cy, bw, bh, conf, _ = self._decode(x)
        # IoU of each predicted box with the cell's ground-truth box
        gx1, gx2 = g_cx - g_w / 2, g_cx + g_w / 2
        gy1, gy2 = g_cy - g_h / 2, g_cy + g_h / 2
        px1, px2 = cx - bw / 2, cx + bw / 2
        py1, py2 = cy - bh / 2, cy + bh / 2
        ix = torch.clamp(torch.minimum(px2, gx2[..., None])
                         - torch.maximum(px1, gx1[..., None]), min=0.0)
        iy = torch.clamp(torch.minimum(py2, gy2[..., None])
                         - torch.maximum(py1, gy1[..., None]), min=0.0)
        inter = ix * iy
        union = bw * bh + (g_w * g_h)[..., None] - inter
        iou = inter / torch.clamp(union, min=1e-9)             # (N,H,W,B)

        # the responsible box: best IoU (the first on ties), no gradient
        best = torch.argmax(iou.detach(), dim=-1)
        resp = F.one_hot(best, b).to(f32) * obj_mask[..., None]

        # coordinates: (sigmoid(t), sqrt size) against the truth
        cell_x = g_cx - torch.floor(g_cx)
        cell_y = g_cy - torch.floor(g_cy)
        anchors = self._anchors(x)
        pred_sw = torch.sqrt(torch.clamp(anchors[:, 0] * torch.exp(tw),
                                         min=1e-9))
        pred_sh = torch.sqrt(torch.clamp(anchors[:, 1] * torch.exp(th),
                                         min=1e-9))
        loss_xy = (torch.square(torch.sigmoid(tx) - cell_x[..., None])
                   + torch.square(torch.sigmoid(ty) - cell_y[..., None]))
        loss_wh = (torch.square(pred_sw - torch.sqrt(g_w)[..., None])
                   + torch.square(pred_sh - torch.sqrt(g_h)[..., None]))
        coord = self.lambda_coord * torch.sum(resp * (loss_xy + loss_wh))

        # confidence: the IoU (no gradient) for responsible boxes, else 0
        conf_obj = torch.sum(resp * torch.square(conf - iou.detach()))
        conf_noobj = self.lambda_no_obj * torch.sum(
            (1.0 - resp) * torch.square(conf))

        # classes: softmax cross-entropy of the responsible box's logits
        logp = torch.log_softmax(tc, dim=-1)                   # (N,H,W,B,C)
        resp_logp = torch.sum(resp[..., None] * logp, dim=3)
        cls = -torch.sum(g_cls * resp_logp)

        total = coord + conf_obj + conf_noobj + cls
        return total / max(float(n), 1.0)


@dataclasses.dataclass
class DetectedObject:
    """Analog of objdetect/DetectedObject.java."""
    example: int
    center_x: float
    center_y: float
    width: float
    height: float
    predicted_class: int
    confidence: float

    @property
    def top_left(self):
        return (self.center_x - self.width / 2,
                self.center_y - self.height / 2)

    @property
    def bottom_right(self):
        return (self.center_x + self.width / 2,
                self.center_y + self.height / 2)


def iou(a: DetectedObject, b: DetectedObject) -> float:
    """YoloUtils.iou."""
    ax1, ay1 = a.top_left
    ax2, ay2 = a.bottom_right
    bx1, by1 = b.top_left
    bx2, by2 = b.bottom_right
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a.width * a.height + b.width * b.height - inter
    return inter / union if union > 0 else 0.0


def get_predicted_objects(layer: Yolo2OutputLayer, network_output,
                          threshold: float = 0.5,
                          nms_threshold: Optional[float] = 0.4
                          ) -> List[DetectedObject]:
    """Decode, confidence threshold and greedy per-class non-max
    suppression (YoloUtils.getPredictedObjects + nms). The decode runs on
    the output's device in f32; the threshold and the NMS run on the host
    over the surviving boxes."""
    y = torch.as_tensor(network_output).to(torch.float32)
    with torch.no_grad():
        cx, cy, bw, bh, conf, probs = layer._decode(y)
        cls = torch.argmax(probs, dim=-1)
        score = conf * probs.amax(dim=-1)
    cx, cy, bw, bh, score, cls = (v.cpu().numpy()
                                  for v in (cx, cy, bw, bh, score, cls))
    out: List[DetectedObject] = []
    for nidx, hy, wx, bi in np.argwhere(score > threshold):
        out.append(DetectedObject(
            int(nidx), float(cx[nidx, hy, wx, bi]),
            float(cy[nidx, hy, wx, bi]), float(bw[nidx, hy, wx, bi]),
            float(bh[nidx, hy, wx, bi]), int(cls[nidx, hy, wx, bi]),
            float(score[nidx, hy, wx, bi])))
    if nms_threshold is None:
        return out
    out.sort(key=lambda d: -d.confidence)
    kept: List[DetectedObject] = []
    for d in out:
        if all(not (k.example == d.example
                    and k.predicted_class == d.predicted_class
                    and iou(k, d) > nms_threshold) for k in kept):
            kept.append(d)
    return kept
