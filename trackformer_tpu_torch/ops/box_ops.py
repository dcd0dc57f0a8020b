"""Box geometry (cxcywh/xyxy conversions, areas, IoU, GIoU, clipping).

Counterpart of `trackformer_tpu/ops/box_ops.py`; every function broadcasts
over leading batch dimensions and is safe on padded (degenerate) boxes.
"""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack(
        [(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, clamped at 0 so padded boxes stay harmless."""
    w = (b[..., 2] - b[..., 0]).clamp(min=0.0)
    h = (b[..., 3] - b[..., 1]).clamp(min=0.0)
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 0.0):
    """Pairwise IoU (..., N, 4) x (..., M, 4) -> (iou, union), (..., N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / (union + eps) if eps else inter / union
    return iou, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                        eps: float = 1e-7) -> torch.Tensor:
    """Pairwise GIoU on xyxy boxes -> (..., N, M). Degenerate padded boxes
    are tolerated through the eps in the denominators; callers mask padded
    entries."""
    iou, union = box_iou(boxes1, boxes2, eps=eps)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / (area + eps)


def elementwise_generalized_box_iou(boxes1: torch.Tensor,
                                    boxes2: torch.Tensor,
                                    eps: float = 1e-7) -> torch.Tensor:
    """GIoU between aligned box pairs (..., 4) x (..., 4) -> (...): the
    matched diagonal the box loss needs, without the N x M matrix."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / (union + eps)
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / (area_c + eps)


def clip_boxes_to_image(boxes: torch.Tensor, size) -> torch.Tensor:
    """Clip xyxy boxes to [0, w] x [0, h]; `size` is (h, w), numbers or
    0-d tensors."""
    h, w = size[0], size[1]
    limit = torch.stack([torch.as_tensor(v, dtype=boxes.dtype,
                                         device=boxes.device)
                         for v in (w, h, w, h)])
    return torch.minimum(boxes.clamp(min=0), limit)
