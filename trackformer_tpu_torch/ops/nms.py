"""Fixed-shape greedy NMS and greedy column assignment for the tracker.

Counterpart of `trackformer_tpu/ops/nms.py`. The JAX package unrolls the
greedy loop over the slots; eagerly that would be ~8 small launches per
slot. `nms_mask` instead iterates the greedy rule as a fixed point (see
there), which reaches the same keep mask in a few vector steps.
"""
from __future__ import annotations

from typing import Callable

import torch

from .box_ops import box_iou


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask (N,), torchvision semantics: highest score
    first, a kept valid box suppresses valid boxes with IoU > threshold.

    With the boxes in greedy order, box i is kept iff it is valid and no
    earlier KEPT box overlaps it. That recursion has exactly one solution,
    and iterating keep <- valid & ~any(earlier kept overlapping) from
    keep = valid fixes at least one more box per step, so the first
    repeated mask is the greedy answer (at most N + 1 steps, usually a
    few). The order is a stable sort, as `jnp.argsort` is.
    """
    n = boxes.shape[0]
    iou, _ = box_iou(boxes, boxes, eps=1e-9)
    order = torch.argsort(-torch.where(valid, scores, -torch.inf),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=boxes.device)
    # suppresses[j, i]: valid box j comes before box i and overlaps it
    suppresses = ((iou > iou_threshold) & (rank[:, None] < rank[None, :])
                  & valid[:, None])
    keep = valid
    for _ in range(n + 1):
        new = valid & ~(suppresses & keep[:, None]).any(0)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def greedy_assign_by_column(score_matrix: torch.Tensor,
                            row_valid: torch.Tensor, col_valid: torch.Tensor,
                            accept_fn: Callable, maximize: bool = True
                            ) -> torch.Tensor:
    """For each valid column j in order, pick the best remaining valid row
    i; if accept_fn(value, i) holds, the row wins and is removed. Returns
    the (R,) mask of rows that won a column."""
    r, c = score_matrix.shape
    bad = -torch.inf if maximize else torch.inf
    assigned = torch.zeros(r, dtype=torch.bool, device=score_matrix.device)
    for j in range(c):
        col = torch.where(row_valid & ~assigned, score_matrix[:, j], bad)
        i = col.argmax() if maximize else col.argmin()
        val = col[i]
        ok = col_valid[j] & accept_fn(val, i) & torch.isfinite(val)
        assigned[i] = assigned[i] | ok
    return assigned
