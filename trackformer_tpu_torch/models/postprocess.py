"""Output post-processing to absolute-coordinate detections.

Counterpart of `trackformer_tpu/models/postprocess.py`:
`postprocess_softmax` (vanilla DETR: softmax over the classes, the max over
all but the no-object column) and `postprocess_sigmoid` (Deformable DETR
with the focal loss: per-class sigmoid, the max over ALL columns, the
no-object column included, as the reference does; consumers filter by
label).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops import box_ops


def _scale_boxes(out_bbox: torch.Tensor,
                 target_sizes: torch.Tensor) -> torch.Tensor:
    boxes = box_ops.box_cxcywh_to_xyxy(out_bbox)
    img_h = target_sizes[:, 0].float()
    img_w = target_sizes[:, 1].float()
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)
    return boxes * scale[:, None, :]


def postprocess_softmax(outputs: Dict, target_sizes: torch.Tensor) -> Dict:
    """target_sizes (B, 2) as (h, w) -> scores, labels, xyxy boxes and the
    no-object probability (B, Q)."""
    prob = outputs["pred_logits"].float().softmax(-1)
    scores, labels = prob[..., :-1].max(-1)
    return {"scores": scores, "labels": labels,
            "boxes": _scale_boxes(outputs["pred_boxes"], target_sizes),
            "scores_no_object": prob[..., -1]}


def postprocess_sigmoid(outputs: Dict, target_sizes: torch.Tensor) -> Dict:
    """target_sizes (B, 2) as (h, w) -> scores, labels, xyxy boxes (B, Q)."""
    prob = outputs["pred_logits"].sigmoid()
    scores = prob.amax(-1)
    return {"scores": scores, "labels": prob.argmax(-1),
            "boxes": _scale_boxes(outputs["pred_boxes"], target_sizes)}
