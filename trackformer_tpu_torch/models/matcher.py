"""Hungarian matcher on padded targets, on the tensors' device.

Counterpart of `trackformer_tpu/models/matcher.py`: class/L1/GIoU cost
matrix with the track-query constraints. A false-positive track query
cannot be matched; a matched track query is pinned to its target (cost -1)
and that target is blocked for every other query. Padded target slots get
constant cost, which leaves the optimum over the real ones unchanged;
padded or invalid query slots are blocked from real targets. The exact
solver (`ops/assignment.py`) runs over the batch in lockstep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..ops import box_ops
from ..ops.assignment import BIG, hungarian_batched
from ..structures import Targets


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    focal_loss: bool = False
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


def _cost_matrix(outputs: Dict, targets: Targets,
                 cfg: MatcherConfig) -> torch.Tensor:
    """(B, Qt, T) combined cost, before track-query/padding constraints."""
    logits = outputs["pred_logits"].float()   # (B, Qt, C)
    boxes = outputs["pred_boxes"].float()     # (B, Qt, 4)
    qt = logits.shape[1]
    tgt_ids = targets.labels.long()[:, None, :].expand(-1, qt, -1)
    tgt_boxes = targets.boxes                 # (B, T, 4)

    if cfg.focal_loss:
        prob = logits.sigmoid()
        neg = ((1 - cfg.focal_alpha) * prob ** cfg.focal_gamma
               * -torch.log1p(-prob + 1e-8))
        pos = (cfg.focal_alpha * (1 - prob) ** cfg.focal_gamma
               * -torch.log(prob + 1e-8))
        cost_class = pos.gather(2, tgt_ids) - neg.gather(2, tgt_ids)
    else:
        cost_class = -logits.softmax(-1).gather(2, tgt_ids)

    cost_bbox = (boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    cost_giou = -box_ops.generalized_box_iou(
        box_ops.box_cxcywh_to_xyxy(boxes),
        box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    return (cfg.cost_bbox * cost_bbox + cfg.cost_class * cost_class
            + cfg.cost_giou * cost_giou)


def _apply_constraints(cost: torch.Tensor, query_valid: torch.Tensor,
                       targets: Targets) -> torch.Tensor:
    """Apply padding and track-query constraints to one batch of costs."""
    b, qt, t = cost.shape
    t_valid = targets.valid[:, None, :]       # (B, 1, T)

    # padded target slots: constant 0 (neutral); invalid queries cannot
    # take real targets
    cost = torch.where(t_valid, cost, 0.0)
    cost = torch.where(~query_valid[:, :, None] & t_valid, BIG, cost)

    if targets.tq_valid is not None:
        k = targets.tq_valid.shape[1]
        dev = cost.device
        fal_pos = targets.tq_fal_pos & targets.tq_valid           # (B, K)
        pad = torch.zeros(b, qt - k, dtype=torch.bool, device=dev)
        fal_pos_rows = torch.cat([fal_pos, pad], 1)
        cost = torch.where(fal_pos_rows[:, :, None] & t_valid, BIG, cost)

        pinned = (targets.tq_valid & ~targets.tq_fal_pos
                  & (targets.tq_match_idx >= 0))                  # (B, K)
        pin_t = targets.tq_match_idx.long().clamp(0, t - 1)
        onehot_k = (torch.nn.functional.one_hot(pin_t, t).bool()
                    & pinned[..., None])
        pin_onehot = torch.cat(
            [onehot_k, torch.zeros(b, qt - k, t, dtype=torch.bool,
                                   device=dev)], 1)               # (B, Qt, T)
        pinned_rows = torch.cat([pinned, pad], 1)                 # (B, Qt)
        pinned_cols = onehot_k.any(1)                             # (B, T)

        cost = torch.where(pinned_rows[:, :, None] & ~pin_onehot, BIG, cost)
        cost = torch.where(pinned_cols[:, None, :] & ~pin_onehot, BIG, cost)
        cost = torch.where(pin_onehot, -1.0, cost)
    return cost


@torch.no_grad()
def match(outputs: Dict, targets: Targets,
          cfg: MatcherConfig) -> torch.Tensor:
    """-> (B, T) int64: the query index matched to each target slot.
    Entries of invalid target slots mean nothing (mask with targets.valid).
    Requires T <= Qt."""
    query_valid = outputs.get("query_valid")
    if query_valid is None:
        query_valid = torch.ones(outputs["pred_logits"].shape[:2],
                                 dtype=torch.bool,
                                 device=outputs["pred_logits"].device)
    cost = _cost_matrix(outputs, targets, cfg)
    cost = _apply_constraints(cost, query_valid, targets)
    # rows = targets (R <= C), solved exactly
    cost_tq = cost.transpose(1, 2)
    if cost_tq.shape[1] > cost_tq.shape[2]:
        raise ValueError(f"max_objects ({cost_tq.shape[1]}) must be <= total "
                         f"queries ({cost_tq.shape[2]})")
    return hungarian_batched(cost_tq)
