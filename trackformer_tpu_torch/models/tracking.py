"""Training-time track queries and the two-frame training forward.

Counterpart of `trackformer_tpu/models/tracking.py`.
`add_track_queries_to_targets` builds the track queries of frame t from the
model's matched outputs on frame t-1:

  * a random subset of the previous frame's matched targets (false
    negatives / query dropout), its size shared across the batch:
    uniform over [0, min valid targets];
  * injected false positives drawn from the previous frame's unused
    outputs, with probability rising with the centre distance to a matched
    box;
  * per-slot masks for the matcher (pinning) and the criterion (eos
    reweighting).

`tracking_train_forward` runs the previous frame without gradient and
injects the result into the current frame (`backprop_prev_frame` and the
three-frame variant are not ported).

Static layout: K = max_objects + fp_capacity slots; slot k < num holds the
k-th member of the subset, slots [T, T + num_fps) the false positives, the
rest are invalid. Randomness comes from an explicit `torch.Generator` on
the tensors' device; its draws cannot equal `jax.random`'s, so the parity
tests pin both sides with `forced`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..structures import Targets
from .matcher import MatcherConfig, match


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    false_positive_prob: float = 0.1
    # kept for config parity: the subset size comes from the shared draw
    false_negative_prob: float = 0.4
    backprop_prev_frame: bool = False
    matcher: MatcherConfig = MatcherConfig()


def fp_capacity(max_objects: int, fp_prob: float) -> int:
    return int(math.ceil(fp_prob * max_objects)) + 1


@torch.no_grad()
def add_track_queries_to_targets(
        generator: Optional[torch.Generator],
        targets: Targets,
        prev_targets: Targets,
        prev_out: dict,
        prev_match_q: torch.Tensor,
        cfg: TrackingConfig,
        add_false_pos: bool = True,
        forced: Optional[dict] = None) -> Targets:
    """Build padded track-query slots on `targets` from the previous
    frame's outputs. prev_match_q (B, T): the query matched to each
    previous target slot.

    `forced` (tests only) pins the draws: a dict with 'num' (subset size),
    'num_fps', 'order' (B, T) subset permutation and 'fp_seed_pos' (B, T)
    false-positive seed positions; the candidate picks then take the
    argmax of the distance weights instead of the weighted Gumbel draw.
    """
    b, t = prev_targets.valid.shape
    dev = prev_targets.valid.device
    prev_boxes = prev_out["pred_boxes"].float()         # (B, Q, 4)
    prev_hs = prev_out["hs_embed"].float()              # (B, Q, C)
    q = prev_boxes.shape[1]
    kfp = fp_capacity(t, cfg.false_positive_prob) if add_false_pos else 0
    k_total = t + kfp
    slots = torch.arange(t, device=dev)
    items = torch.arange(b, device=dev)[:, None]

    def uniform(*shape):
        return torch.rand(*shape, device=dev, generator=generator)

    if forced is None:
        min_valid = int(prev_targets.valid.sum(1).min())
        # shared subset size: uniform over [0, min_valid]
        num = int(torch.randint(0, min_valid + 1, (), device=dev,
                                generator=generator))
        # shared count of false positives: uniform over [0, ceil(p * num)]
        fp_hi = int(math.ceil(cfg.false_positive_prob * num)) + 1
        num_fps = (int(torch.randint(0, fp_hi, (), device=dev,
                                     generator=generator))
                   if num > 0 and add_false_pos else 0)
        # random order, valid previous target slots first
        noise = uniform(b, t)
        order = torch.argsort(torch.where(prev_targets.valid, noise,
                                          noise + 10.0), 1)
    else:
        num = int(forced["num"])
        num_fps = int(forced.get("num_fps", 0))
        order = torch.as_tensor(forced["order"], device=dev).long()

    sel = (slots < num)[None].expand(b, -1)             # subset positions
    slot_q = prev_match_q.gather(1, order)              # prev query per slot
    slot_track_id = prev_targets.track_ids.gather(1, order)

    # match previous track ids to the current frame's target slots
    eq = ((slot_track_id[:, :, None] == targets.track_ids[:, None, :])
          & targets.valid[:, None, :] & (slot_track_id[:, :, None] >= 0))
    matched = eq.any(2) & sel
    matched_idx = eq.int().argmax(2)

    boxes_sub = prev_boxes[items, slot_q]               # (B, T, 4)
    hs_sub = prev_hs[items, slot_q]

    tq_boxes = torch.zeros(b, k_total, 4, device=dev)
    tq_hs = torch.zeros(b, k_total, prev_hs.shape[-1], device=dev)
    tq_valid = torch.zeros(b, k_total, dtype=torch.bool, device=dev)
    tq_fal_pos = torch.zeros(b, k_total, dtype=torch.bool, device=dev)
    tq_match = torch.full((b, k_total), -1, dtype=torch.int32, device=dev)
    tq_boxes[:, :t] = boxes_sub
    tq_hs[:, :t] = hs_sub
    tq_valid[:, :t] = sel
    tq_fal_pos[:, :t] = sel & ~matched
    tq_match[:, :t] = torch.where(matched, matched_idx, -1).int()

    if kfp:
        # candidates: previous outputs that no subset slot uses
        used = torch.zeros(b, q, dtype=torch.bool, device=dev)
        used[items.expand(-1, t)[sel], slot_q[sel]] = True
        if forced is None:
            # subset positions seeding each false positive
            pnoise = uniform(b, t)
            fp_seed_pos = torch.argsort(torch.where(sel, pnoise,
                                                    pnoise + 10.0), 1)
        else:
            fp_seed_pos = torch.as_tensor(
                forced.get("fp_seed_pos", torch.zeros(b, t)),
                device=dev).long()
        # matched subset positions in subset order: false positive j is
        # seeded from the j-th MATCHED box when there is one, else picked
        # uniformly
        mpos = torch.argsort((~matched).int(), dim=1, stable=True)
        n_matched = matched.sum(1)
        picks = []
        for j in range(kfp):
            j_val = fp_seed_pos[:, j]
            seed_ok = j_val < n_matched
            seed_slot = mpos.gather(1, j_val.clamp(0, t - 1)[:, None])
            seed_box = boxes_sub[items, seed_slot][:, 0]          # (B, 4)
            d = prev_boxes[:, :, :2] - seed_box[:, None, :2]
            w = (d * d).sum(2).sqrt() + 1e-8
            w = torch.where(seed_ok[:, None], w, 1.0)
            w = torch.where(used, 0.0, w)
            logw = w.clamp(min=1e-30).log()
            if forced is None:
                u = uniform(b, q).clamp(min=1e-20)
                logw = logw - torch.log(-torch.log(u))           # + Gumbel
            pick = logw.argmax(1)
            used[items[:, 0], pick] = True
            picks.append(pick)
        picks = torch.stack(picks, 1)                             # (B, kfp)
        fp_on = (torch.arange(kfp, device=dev) < num_fps)[None].expand(b, -1)
        tq_boxes[:, t:] = torch.where(fp_on[..., None],
                                      prev_boxes[items, picks], 0.0)
        tq_hs[:, t:] = torch.where(fp_on[..., None], prev_hs[items, picks],
                                   0.0)
        tq_valid[:, t:] = fp_on
        tq_fal_pos[:, t:] = fp_on

    return targets.with_track_queries(tq_hs, tq_boxes, tq_valid, tq_fal_pos,
                                      tq_match)


def tracking_train_forward(apply_fn: Callable, batch, targets: Targets,
                           prev_batch, prev_targets: Targets,
                           generator: Optional[torch.Generator],
                           cfg: TrackingConfig,
                           prev_prev_batch=None,
                           prev_prev_targets: Optional[Targets] = None,
                           forced: Optional[dict] = None,
                           mark: Optional[Callable[[str], None]] = None
                           ) -> Tuple[dict, Targets]:
    """The two-frame training forward. `apply_fn(batch, targets,
    prev_features)` -> the model's 5-tuple, the model in training mode (the
    previous frame runs with dropout active too, without gradient).
    Returns (out, targets with track queries) of the current frame.
    `mark(tag)`, if given, is called after the previous frame's forward
    ("forward_prev") and after the match and augmentation
    ("match_augment")."""
    if prev_prev_batch is not None or prev_prev_targets is not None:
        raise NotImplementedError("the three-frame forward "
                                  "(track_prev_prev_frame) is not ported yet")
    if cfg.backprop_prev_frame:
        raise NotImplementedError("backprop_prev_frame is not ported yet")
    with torch.no_grad():
        prev_out, _, prev_feats, _, _ = apply_fn(prev_batch, None, None)
    if mark is not None:
        mark("forward_prev")
    prev_match_q = match(prev_out, prev_targets, cfg.matcher)
    targets = add_track_queries_to_targets(
        generator, targets, prev_targets, prev_out, prev_match_q, cfg,
        forced=forced)
    if mark is not None:
        mark("match_augment")
    out, targets, _, _, _ = apply_fn(batch, targets, prev_feats)
    return out, targets
