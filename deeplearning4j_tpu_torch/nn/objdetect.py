"""Object detection: the YOLOv2 output layer and its post-processing (the
port of ``deeplearning4j_tpu/nn/objdetect.py``).

Conventions as in the JAX package (and DL4J):

- network output per grid cell: B anchor boxes x (tx, ty, tw, th, conf)
  then C class scores; activations: sigmoid on xy and conf, exp on wh
  (scaled by the anchor priors), softmax over the classes;
- labels [N, 4 + C, gridH, gridW]: channels 0..3 are (x1, y1, x2, y2) of
  the ground-truth box in grid units at its responsible cell, then a
  one-hot class; cells without an object are all zero;
- loss: ``lambda_coord`` x the coordinate SSE + the confidence loss (IoU
  target on responsible anchors, ``lambda_noobj`` elsewhere) + the class
  cross-entropy on responsible cells, divided by N.

The output layer is a ``BaseOutputLayer``, so under a bf16 policy it is
an fp32 island (``nn.layers.policy_cast``).
"""

from __future__ import annotations

import weakref
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.layers import BaseOutputLayer


class DetectedObject:
    """ref: org.deeplearning4j.nn.layers.objdetect.DetectedObject."""

    def __init__(self, example: int, center_x: float, center_y: float,
                 width: float, height: float, predicted_class: int,
                 confidence: float):
        self.example = example
        self.center_x = center_x
        self.center_y = center_y
        self.width = width
        self.height = height
        self.predicted_class = predicted_class
        self.confidence = confidence

    def getTopLeftXY(self):
        return self.center_x - self.width / 2, self.center_y - self.height / 2

    def getBottomRightXY(self):
        return self.center_x + self.width / 2, self.center_y + self.height / 2

    def getPredictedClass(self):
        return self.predicted_class

    def __repr__(self):
        return (f"DetectedObject(ex={self.example} cls={self.predicted_class} "
                f"conf={self.confidence:.3f} cx={self.center_x:.2f} "
                f"cy={self.center_y:.2f} w={self.width:.2f} "
                f"h={self.height:.2f})")


#: layer -> {(device, dtype): anchors tensor}
_ANCHORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class Yolo2OutputLayer(BaseOutputLayer):
    """ref: conf.layers.objdetect.Yolo2OutputLayer — no params; applies
    the YOLO activations and computes the YOLOv2 loss."""

    input_kind = "cnn"
    has_params = False

    def __init__(self, boundingBoxPriors=None, lambdaCoord: float = 5.0,
                 lambdaNoObj: float = 0.5, **kw):
        kw.setdefault("lossFunction", "mse")
        super().__init__(**kw)
        # [B, 2] (w, h) in grid units
        self.anchors = np.asarray(boundingBoxPriors
                                  if boundingBoxPriors is not None
                                  else [[1.0, 1.0]], np.float32)
        self.lambda_coord = lambdaCoord
        self.lambda_noobj = lambdaNoObj
        self.activation = "identity"

    def infer_nin(self, it: InputType):
        self.nIn = self.nOut = it.channels
        self._grid_h, self._grid_w = it.height, it.width
        b = self.anchors.shape[0]
        if it.channels % b:
            raise ValueError(f"channels {it.channels} not divisible by "
                             f"{b} anchors")
        self._n_classes = it.channels // b - 5

    def output_type(self, it: InputType) -> InputType:
        return it

    def _anchors(self, like):
        """The anchors as a tensor of ``like``'s dtype on its device, made
        once a (device, dtype): a host-to-device copy inside the step
        would be one a step, and a captured step cannot make it."""
        per_layer = _ANCHORS.setdefault(self, {})
        key = (like.device, like.dtype)
        if key not in per_layer:
            per_layer[key] = torch.as_tensor(self.anchors, dtype=like.dtype,
                                             device=like.device)
        return per_layer[key]

    def _split(self, x):
        """x [N, B*(5+C), H, W] -> (xy [N,B,2,H,W], wh, conf [N,B,H,W],
        class logits [N,B,C,H,W])."""
        N, ch, H, W = x.shape
        B = self.anchors.shape[0]
        x = x.reshape(N, B, ch // B, H, W)
        return x[:, :, 0:2], x[:, :, 2:4], x[:, :, 4], x[:, :, 5:]

    def apply(self, params, state, x, train, key=None):
        """sigmoid(xy), anchors*exp(wh), sigmoid(conf), softmax over the
        classes, repacked to [N, B*(5+C), H, W] (ref:
        Yolo2OutputLayer.activate)."""
        txy, twh, tconf, tcls = self._split(x)
        xy = torch.sigmoid(txy)
        wh = self._anchors(x)[None, :, :, None, None] * torch.exp(twh)
        conf = torch.sigmoid(tconf)[:, :, None]
        cls = torch.softmax(tcls, dim=2)
        out = torch.cat([xy, wh, conf, cls], dim=2)
        N, B, ch, H, W = out.shape
        return out.reshape(N, B * ch, H, W), state

    def compute_loss(self, labels, preds, mask=None):
        """labels [N, 4+C, H, W]; preds the activated output of
        :meth:`apply`. The IoU target of the confidence loss carries no
        gradient (``stop_gradient`` in the JAX package)."""
        N, ch, H, W = preds.shape
        B = self.anchors.shape[0]
        p = preds.reshape(N, B, ch // B, H, W)
        pred_xy = p[:, :, 0:2]           # offsets within the cell, [0, 1]
        pred_wh = p[:, :, 2:4]           # grid units
        pred_conf = p[:, :, 4]
        pred_cls = p[:, :, 5:]

        labels = labels.to(preds.dtype)
        lab_cls = labels[:, 4:]                           # [N, C, H, W]
        obj_mask = (lab_cls.sum(dim=1) > 0).to(preds.dtype)   # [N, H, W]
        gx1, gy1, gx2, gy2 = (labels[:, i] for i in range(4))
        gt_w = torch.clamp_min(gx2 - gx1, 1e-6)
        gt_h = torch.clamp_min(gy2 - gy1, 1e-6)
        dev = preds.device
        cell_x = torch.arange(W, device=dev, dtype=preds.dtype)[None, None, :]
        cell_y = torch.arange(H, device=dev, dtype=preds.dtype)[None, :, None]
        gt_cx = (gx1 + gx2) / 2 - cell_x
        gt_cy = (gy1 + gy2) / 2 - cell_y

        # responsible anchor: best IoU with the box by shape (wh only);
        # argmax takes the first index on ties, as jnp.argmax does
        anchors = self._anchors(preds)
        aw = anchors[:, 0][None, :, None, None]
        ah = anchors[:, 1][None, :, None, None]
        inter = torch.minimum(aw, gt_w[:, None]) * \
            torch.minimum(ah, gt_h[:, None])
        union = aw * ah + (gt_w * gt_h)[:, None] - inter
        anchor_iou = inter / torch.clamp_min(union, 1e-9)     # [N,B,H,W]
        best = torch.argmax(anchor_iou, dim=1)                 # [N,H,W]
        resp = torch.nn.functional.one_hot(best, B).permute(0, 3, 1, 2) \
            .to(preds.dtype) * obj_mask[:, None]               # [N,B,H,W]

        xy_loss = (resp[:, :, None] * torch.square(
            pred_xy - torch.stack([gt_cx, gt_cy], dim=1)[:, None])).sum(2)
        wh_loss = (resp[:, :, None] * torch.square(
            torch.sqrt(torch.clamp_min(pred_wh, 1e-9))
            - torch.sqrt(torch.stack([gt_w, gt_h], dim=1)[:, None]))).sum(2)

        pcx = pred_xy[:, :, 0] + cell_x[None]
        pcy = pred_xy[:, :, 1] + cell_y[None]
        px1, px2 = pcx - pred_wh[:, :, 0] / 2, pcx + pred_wh[:, :, 0] / 2
        py1, py2 = pcy - pred_wh[:, :, 1] / 2, pcy + pred_wh[:, :, 1] / 2
        ix = torch.clamp_min(torch.minimum(px2, gx2[:, None])
                             - torch.maximum(px1, gx1[:, None]), 0.0)
        iy = torch.clamp_min(torch.minimum(py2, gy2[:, None])
                             - torch.maximum(py1, gy1[:, None]), 0.0)
        inter_a = ix * iy
        area_p = torch.clamp_min(px2 - px1, 0) * torch.clamp_min(py2 - py1, 0)
        area_g = (gt_w * gt_h)[:, None]
        iou = inter_a / torch.clamp_min(area_p + area_g - inter_a, 1e-9)
        conf_obj = torch.square(pred_conf - iou.detach()) * resp
        conf_noobj = torch.square(pred_conf) * (1.0 - resp)

        cls_loss = -(lab_cls[:, None] * torch.log(
            torch.clamp_min(pred_cls, 1e-9))).sum(2) * resp

        total = (self.lambda_coord * (xy_loss + wh_loss).sum()
                 + conf_obj.sum() + self.lambda_noobj * conf_noobj.sum()
                 + cls_loss.sum())
        return total / N


class YoloUtils:
    """ref: org.deeplearning4j.nn.layers.objdetect.YoloUtils."""

    @staticmethod
    def getPredictedObjects(anchors, net_output, conf_threshold: float = 0.5,
                            nms_threshold: float = 0.4
                            ) -> List[DetectedObject]:
        """Decode an activated YOLO output [N, B*(5+C), H, W] (a tensor on
        any device, or an array) into DetectedObjects with per-class
        greedy NMS."""
        if isinstance(net_output, torch.Tensor):
            net_output = net_output.detach().float().cpu().numpy()
        out = np.asarray(net_output)
        anchors = np.asarray(anchors, np.float32)
        N, ch, H, W = out.shape
        B = anchors.shape[0]
        out = out.reshape(N, B, ch // B, H, W)
        objs: List[DetectedObject] = []
        for n in range(N):
            cand = []
            for b in range(B):
                conf = out[n, b, 4]
                ys, xs = np.where(conf >= conf_threshold)
                for y, x in zip(ys, xs):
                    cls_probs = out[n, b, 5:, y, x]
                    cls = int(np.argmax(cls_probs))
                    score = float(conf[y, x] * cls_probs[cls])
                    if score >= conf_threshold:
                        cand.append(DetectedObject(
                            n, float(out[n, b, 0, y, x] + x),
                            float(out[n, b, 1, y, x] + y),
                            float(out[n, b, 2, y, x]),
                            float(out[n, b, 3, y, x]), cls, score))
            objs.extend(YoloUtils.nms(cand, nms_threshold))
        return objs

    @staticmethod
    def iou(a: DetectedObject, b: DetectedObject) -> float:
        ax1, ay1 = a.getTopLeftXY()
        ax2, ay2 = a.getBottomRightXY()
        bx1, by1 = b.getTopLeftXY()
        bx2, by2 = b.getBottomRightXY()
        ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        iy = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = ix * iy
        union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
        return inter / union if union > 0 else 0.0

    @staticmethod
    def nms(objects: List[DetectedObject], threshold: float = 0.4
            ) -> List[DetectedObject]:
        """Greedy per-class NMS (ref: YoloUtils.nms): classes in the order
        they first appear, each by falling confidence (stable on ties)."""
        keep: List[DetectedObject] = []
        by_class = {}
        for o in objects:
            by_class.setdefault(o.predicted_class, []).append(o)
        for objs in by_class.values():
            objs = sorted(objs, key=lambda o: -o.confidence)
            while objs:
                best = objs.pop(0)
                keep.append(best)
                objs = [o for o in objs if YoloUtils.iou(best, o) < threshold]
        return keep


def yolo_labels(rng, n: int, classes: int, grid: int = 13) -> np.ndarray:
    """YOLOv2 labels [n, 4 + classes, grid, grid] with 1-3 boxes an image,
    drawn from ``rng``: each box's (x1, y1, x2, y2) in grid units at the
    cell of its centre, then a one-hot class; the other cells all zero."""
    y = np.zeros((n, 4 + classes, grid, grid), np.float32)
    for i in range(n):
        for _ in range(int(rng.integers(1, 4))):
            gx, gy = (int(v) for v in rng.integers(0, grid, 2))
            cx, cy = gx + rng.uniform(0.05, 0.95), gy + rng.uniform(0.05, 0.95)
            w, h = rng.uniform(0.5, 6.0, 2)
            y[i, :4, gy, gx] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            y[i, 4:, gy, gx] = 0.0
            y[i, 4 + int(rng.integers(0, classes)), gy, gx] = 1.0
    return y
