"""Loss primitives: elementwise sigmoid cross-entropy, the sigmoid focal
loss and the DICE loss of the masks.

Counterpart of `trackformer_tpu/ops/losses.py`: masked fixed-shape
reductions, with an optional validity mask instead of boolean indexing over
ragged targets.
"""
from __future__ import annotations

from typing import Optional

import torch


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits, numerically stable."""
    return (logits.clamp(min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       num_boxes: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0,
                       query_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """RetinaNet focal loss, reduced as `loss.mean(1).sum() / num_boxes`.

    logits/targets (B, Q, C); query_mask optional (B, Q) bool marking valid
    query slots (padded slots contribute 0 and leave the mean)."""
    prob = logits.sigmoid()
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    if query_mask is not None:
        loss = loss * query_mask[..., None]
        denom = query_mask.sum(1).clamp(min=1.0)
        per_image = loss.sum((1, 2)) / denom
    else:
        per_image = loss.sum(2).mean(1)
    return per_image.sum() / num_boxes


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              num_boxes: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DICE (F-1) loss of mask logits against binary targets, both (N, ...)
    flattened per row; `valid` (N,) bool zeroes a row's term. Summed over
    the rows and divided by `num_boxes`."""
    probs = logits.sigmoid().reshape(logits.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1)
    numerator = 2.0 * (probs * targets).sum(1)
    denominator = probs.sum(1) + targets.sum(1)
    loss = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    if valid is not None:
        loss = loss * valid
    return loss.sum() / num_boxes
