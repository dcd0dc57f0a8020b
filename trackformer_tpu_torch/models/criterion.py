"""SetCriterion: Hungarian-matched detection and tracking losses on padded
targets.

Counterpart of `trackformer_tpu/models/criterion.py`: the label loss
(softmax cross-entropy with the track-query false-positive eos reweighting,
or sigmoid focal), cardinality error, L1 and GIoU box losses, and the
recursion over the auxiliary decoder outputs. Every loss is a masked
fixed-shape reduction: invalid query slots and padded target slots
contribute exactly zero. The mask losses and the two-stage encoder outputs
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from ..ops import box_ops
from ..ops.losses import sigmoid_binary_cross_entropy
from ..structures import Targets
from .matcher import MatcherConfig, match


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int  # dataset classes (the no-object index == num_classes)
    matcher: MatcherConfig = MatcherConfig()
    weight_dict: Optional[Dict[str, float]] = None
    eos_coef: float = 0.1
    focal_loss: bool = False
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    tracking: bool = False
    track_query_false_positive_eos_weight: bool = True
    losses: Tuple[str, ...] = ("labels", "boxes", "cardinality")


def _scatter_target_classes(outputs, targets: Targets, match_q: torch.Tensor,
                            num_classes: int) -> torch.Tensor:
    """(B, Qt) class targets: a matched query gets its target's label,
    every other one no-object (== num_classes)."""
    b, qt, _ = outputs["pred_logits"].shape
    tc = torch.full((b, qt), num_classes, dtype=torch.long,
                    device=match_q.device)
    values = torch.where(targets.valid, targets.labels.long(), num_classes)
    return tc.scatter(1, match_q, values)


def _fal_pos_rows(outputs, targets: Targets) -> Optional[torch.Tensor]:
    if targets.tq_valid is None:
        return None
    qt = outputs["pred_logits"].shape[1]
    k = targets.tq_valid.shape[1]
    fal_pos = targets.tq_fal_pos & targets.tq_valid
    return torch.cat([fal_pos, torch.zeros(
        fal_pos.shape[0], qt - k, dtype=torch.bool, device=fal_pos.device)], 1)


def _class_error(logits, targets: Targets, match_q) -> torch.Tensor:
    """Share of matched real targets whose query predicts another class
    (logging only)."""
    pred_at = logits.argmax(-1).gather(1, match_q)
    correct = (pred_at == targets.labels) & targets.valid
    n = targets.valid.sum().clamp(min=1)
    return 100.0 * (1.0 - correct.sum() / n)


def loss_labels_ce(outputs, targets: Targets, match_q, num_boxes,
                   cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    logits = outputs["pred_logits"].float()
    q_valid = outputs["query_valid"]
    tc = _scatter_target_classes(outputs, targets, match_q, cfg.num_classes)

    nll = -logits.log_softmax(-1).gather(-1, tc[..., None])[..., 0]
    empty_weight = torch.ones(cfg.num_classes + 1, device=logits.device)
    empty_weight[-1] = cfg.eos_coef
    w = empty_weight[tc]
    loss = nll * w

    if cfg.tracking and cfg.track_query_false_positive_eos_weight:
        fal_pos = _fal_pos_rows(outputs, targets)
        if fal_pos is not None:
            # undo the eos down-weighting for injected false positives
            loss = torch.where(fal_pos, loss / cfg.eos_coef, loss)
            w = empty_weight[torch.where(fal_pos, 0, tc)]

    loss = torch.where(q_valid, loss, 0.0)
    denom = torch.where(q_valid, w, 0.0).sum()
    return {"loss_ce": loss.sum() / denom.clamp(min=1e-6),
            "class_error": _class_error(logits, targets, match_q)}


def loss_labels_focal(outputs, targets: Targets, match_q, num_boxes,
                      cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    logits = outputs["pred_logits"].float()   # (B, Qt, C)
    q_valid = outputs["query_valid"]
    tc = _scatter_target_classes(outputs, targets, match_q, cfg.num_classes)

    c = logits.shape[-1]
    # An unmatched query scatters a ONE at the LAST logit column: an
    # explicit background class under the sigmoid focal loss, not an
    # all-zero row (the original's semantics). The background index is
    # always c - 1.
    tc = torch.where(tc >= c, c - 1, tc)
    onehot = F.one_hot(tc, c).to(logits.dtype)
    prob = logits.sigmoid()
    ce = sigmoid_binary_cross_entropy(logits, onehot)
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    loss = ce * (1 - p_t) ** cfg.focal_gamma
    alpha_t = cfg.focal_alpha * onehot + (1 - cfg.focal_alpha) * (1 - onehot)
    loss = alpha_t * loss
    loss = torch.where(q_valid[..., None], loss, 0.0)
    # the original's reduction: loss.sum over (Q, C, B) / num_boxes
    return {"loss_ce": loss.sum() / num_boxes,
            "class_error": _class_error(logits, targets, match_q)}


def loss_cardinality(outputs, targets: Targets, match_q, num_boxes,
                     cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    logits = outputs["pred_logits"]
    q_valid = outputs["query_valid"]
    not_empty = (logits.argmax(-1) != logits.shape[-1] - 1) & q_valid
    card_pred = not_empty.sum(1).float()
    tgt_len = targets.valid.sum(1).float()
    return {"cardinality_error": (card_pred - tgt_len).abs().mean()}


def loss_boxes(outputs, targets: Targets, match_q, num_boxes,
               cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    boxes = outputs["pred_boxes"].float()     # (B, Qt, 4)
    src = boxes.gather(1, match_q[..., None].expand(-1, -1, 4))   # (B, T, 4)
    tgt = targets.boxes
    valid = targets.valid

    l1 = torch.where(valid, (src - tgt).abs().sum(-1), 0.0)
    giou = box_ops.elementwise_generalized_box_iou(
        box_ops.box_cxcywh_to_xyxy(src), box_ops.box_cxcywh_to_xyxy(tgt))
    giou_loss = torch.where(valid, 1.0 - giou, 0.0)
    return {"loss_bbox": l1.sum() / num_boxes,
            "loss_giou": giou_loss.sum() / num_boxes}


def loss_masks(outputs, targets: Targets, match_q, num_boxes,
               cfg: CriterionConfig):
    raise NotImplementedError("the mask losses are not ported yet")


LOSS_MAP = {
    "boxes": loss_boxes,
    "cardinality": loss_cardinality,
    "masks": loss_masks,
}


def compute_losses(outputs: Dict, targets: Targets, cfg: CriterionConfig,
                   num_boxes: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """The full criterion: match, then the losses, for the final and the
    auxiliary outputs (keys suffixed `_i`). `num_boxes` defaults to the
    number of valid targets, at least 1."""
    if "enc_outputs" in outputs:
        raise NotImplementedError("two-stage encoder outputs are not ported "
                                  "yet")
    if num_boxes is None:
        num_boxes = targets.valid.sum().float().clamp(min=1.0)
    label_fn = loss_labels_focal if cfg.focal_loss else loss_labels_ce

    def run(outs, prefix="", log=True):
        match_q = match(outs, targets, cfg.matcher)
        d = {}
        for name in cfg.losses:
            if name == "labels":
                ld = label_fn(outs, targets, match_q, num_boxes, cfg)
                if not log:
                    ld.pop("class_error", None)
            else:
                ld = LOSS_MAP[name](outs, targets, match_q, num_boxes, cfg)
            d.update({k + prefix: v for k, v in ld.items()})
        return d

    losses = run(outputs)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        losses.update(run(aux, prefix=f"_{i}", log=False))
    return losses
