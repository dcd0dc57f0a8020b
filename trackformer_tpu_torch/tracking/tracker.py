"""Online multi-object tracker: a fixed-slot state machine on the device.

Counterpart of `trackformer_tpu/tracking/tracker.py`. The tracker state is
a `TrackerState` of S fixed slots with masks: a slot is `active`,
`inactive`, or free. Each per-track list operation of the reference
tracker is a masked tensor op. The step runs the model and the whole track
logic on the device; the host shell keeps the prev-feature deque and
appends the per-frame results.

Semantics follow the JAX package, including its documented deviations:
new tracks fill free slots in slot order, and surplus detections beyond
the free slots are dropped. With `with_masks` (a mask model) every slot
carries its mask probabilities at the mask head's stride-4 resolution of
the padded frame; overlaps are resolved there (each pixel to the active
track of the highest probability) and the host rescales the masks to the
frame (`utils/track_utils.py:upscale_mask_results`). With an attention
map model (`models/detr.py:AttentionMapDETR`, vanilla DETR's
`generate_attention_maps`) every slot carries the last decoder layer's
head-averaged cross-attention weights over the memory, taken where the
slot's box is taken and cleared in the results of inactive slots. The box
postprocess is the factory's: sigmoid for a focal head, softmax for a
plain one.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import box_ops
from ..ops.assignment import hungarian_rect
from ..ops.nms import greedy_assign_by_column, nms_mask
from ..structures import FrameBatch, empty_targets


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    detection_obj_score_thresh: float = 0.4
    track_obj_score_thresh: float = 0.4
    detection_nms_thresh: float = 0.9
    track_nms_thresh: float = 0.9
    public_detections: Any = False
    inactive_patience: float = -1.0
    reid_sim_threshold: float = 0.0
    reid_sim_only: bool = False
    reid_score_thresh: float = 0.4
    reid_greedy_matching: bool = False
    prev_frame_dist: int = 1
    steps_termination: int = 1
    max_tracks: int = 150
    num_object_queries: int = 300
    overflow_boxes: bool = False
    with_masks: bool = False

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "TrackerConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields}, **kw)


@dataclasses.dataclass
class TrackerState:
    boxes: torch.Tensor           # (S, 4) absolute xyxy
    scores: torch.Tensor          # (S,)
    hs: torch.Tensor              # (S, C) float32
    ids: torch.Tensor             # (S,) int64, -1 when free
    obj_ind: torch.Tensor         # (S,) query index at creation
    active: torch.Tensor          # (S,) bool
    inactive: torch.Tensor        # (S,) bool
    count_inactive: torch.Tensor  # (S,)
    count_term: torch.Tensor      # (S,)
    next_id: torch.Tensor         # ()
    num_reids: torch.Tensor       # ()
    masks: Optional[torch.Tensor] = None  # (S, Hm, Wm) probabilities
    attn_maps: Optional[torch.Tensor] = None  # (S, Ha, Wa) attention maps

    def replace(self, **changes) -> "TrackerState":
        return dataclasses.replace(self, **changes)


def init_state(max_tracks: int, hidden_dim: int,
               device: torch.device | str = torch.device("cuda"),
               mask_hw: Optional[tuple] = None) -> TrackerState:
    """Free slots; with `mask_hw` each with an all-zero mask."""
    s = max_tracks

    def ints(fill):
        return torch.full((s,), fill, dtype=torch.long, device=device)

    return TrackerState(
        boxes=torch.zeros(s, 4, device=device),
        scores=torch.zeros(s, device=device),
        hs=torch.zeros(s, hidden_dim, device=device),
        ids=ints(-1), obj_ind=ints(-1),
        active=torch.zeros(s, dtype=torch.bool, device=device),
        inactive=torch.zeros(s, dtype=torch.bool, device=device),
        count_inactive=ints(0), count_term=ints(0),
        next_id=torch.zeros((), dtype=torch.long, device=device),
        num_reids=torch.zeros((), dtype=torch.long, device=device),
        masks=(None if mask_hw is None else
               torch.zeros((s,) + tuple(mask_hw), device=device)))


def mask_hw_of(hw) -> tuple:
    """The mask head's output size for a padded frame of size `hw`: the
    backbone's stride-4 level, ceil(ceil(h / 2) / 2) each way (the JAX
    tracker probes it with a forward)."""
    return tuple((int(x) + 3) // 4 for x in hw)


def attn_hw_of(hw, stride: int) -> tuple:
    """The transformer memory's size for a padded frame of size `hw`: the
    backbone's last level, ceil(h / stride) each way (32, or 16 with DC5;
    the JAX tracker probes it with a forward)."""
    return tuple(-(-int(x) // stride) for x in hw)


def _positive_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])


def _prune_inactive(state: TrackerState, cfg: TrackerConfig) -> TrackerState:
    """Drop inactive slots past patience or with degenerate boxes."""
    keep = (_positive_area(state.boxes)
            & (state.count_inactive <= cfg.inactive_patience))
    drop = state.inactive & ~keep
    return state.replace(inactive=state.inactive & ~drop,
                         ids=torch.where(drop, -1, state.ids))


def _scatter_new_tracks(state: TrackerState, det_keep, det_boxes,
                        det_scores, det_hs, det_masks, cfg: TrackerConfig,
                        det_attn=None):
    """Occupy free slots (in slot order) with the kept detections. Writes
    for detections that find no slot go to a dummy extra slot, dropped."""
    s = cfg.max_tracks
    dev = det_keep.device
    slots = torch.arange(s, device=dev)
    free = ~(state.active | state.inactive)
    n_free = free.sum()
    slot_order = torch.argsort(torch.where(free, slots, s + 1), stable=True)
    rank = det_keep.long().cumsum(0) - 1  # 0-based rank among kept
    ok = det_keep & (rank < n_free)
    slot = torch.where(ok, slot_order[rank.clamp(0, s - 1)], s)

    def put(x, v):
        padded = torch.cat([x, torch.zeros_like(x[:1])])
        padded[slot] = v if torch.is_tensor(v) else torch.as_tensor(
            v, dtype=x.dtype, device=dev)
        return padded[:s]

    q = det_keep.shape[0]
    n_new = ok.sum()
    new_state = state.replace(
        boxes=put(state.boxes, det_boxes),
        scores=put(state.scores, det_scores),
        hs=put(state.hs, det_hs.to(state.hs.dtype)),
        ids=put(state.ids, state.next_id + rank),
        obj_ind=put(state.obj_ind, torch.arange(q, device=dev)),
        active=put(state.active, True),
        count_term=put(state.count_term, 0),
        count_inactive=put(state.count_inactive, 0),
        next_id=state.next_id + n_new,
        masks=(state.masks if state.masks is None or det_masks is None
               else put(state.masks, det_masks)),
        attn_maps=(state.attn_maps if state.attn_maps is None
                   or det_attn is None else put(state.attn_maps, det_attn)))
    new_track_mask = put(torch.zeros(s, dtype=torch.bool, device=dev), True)
    return new_state, new_track_mask


def _public_detections_mask(cfg: TrackerConfig, det_boxes, det_keep,
                            public_boxes, public_valid):
    """Keep only detections matched to a public detection."""
    mode = cfg.public_detections
    if not mode:
        return det_keep
    if mode == "center_distance":
        det_c = box_ops.box_xyxy_to_cxcywh(det_boxes)[:, :2]
        pub_c = box_ops.box_xyxy_to_cxcywh(public_boxes)[:, :2]
        d = det_c[:, None] - pub_c[None]
        dist = (d * d).sum(-1)
        area = box_ops.box_area(det_boxes)
        assigned = greedy_assign_by_column(
            dist, det_keep, public_valid,
            accept_fn=lambda v, i: v < area[i], maximize=False)
    elif mode == "min_iou_0_5":
        iou, _ = box_ops.box_iou(det_boxes, public_boxes, eps=1e-9)
        assigned = greedy_assign_by_column(
            iou, det_keep, public_valid,
            accept_fn=lambda v, i: v >= 0.5, maximize=True)
    else:
        raise NotImplementedError(f"public_detections={mode!r}")
    return det_keep & assigned


def _reid(state: TrackerState, det_boxes, det_scores, det_hs, det_masks,
          det_keep, cfg: TrackerConfig):
    """Revive inactive tracks from the remaining detections. Returns
    (state, det_keep). Skipped when no slot is inactive or no detection
    remains."""
    if not bool(state.inactive.any() & det_keep.any()):
        return state, det_keep
    s = cfg.max_tracks
    dev = det_keep.device
    inact = state.inactive

    if cfg.reid_greedy_matching:
        t_c = box_ops.box_xyxy_to_cxcywh(state.boxes)
        d_c = box_ops.box_xyxy_to_cxcywh(det_boxes)
        dd = t_c[:, None, :2] - d_c[None, :, :2]
        dist = (dd * dd).sum(-1)
        track_size = t_c[:, 2] * t_c[:, 3]
        item_size = d_c[:, 2] * d_c[:, 3]
        invalid = (dist > track_size[:, None]) | (dist > item_size[None, :])
        dist = dist + invalid * 1e18
        dist = torch.where(inact[:, None] & det_keep[None, :], dist,
                           torch.inf)
        revive_det = torch.full((s,), -1, dtype=torch.long, device=dev)
        taken = torch.zeros_like(det_keep)
        for i in range(s):  # greedy per inactive row
            row = torch.where(taken, torch.inf, dist[i])
            j = row.argmin()
            ok = inact[i] & (row[j] < 1e16)
            revive_det[i] = torch.where(ok, j, -1)
            taken[j] = taken[j] | ok
    else:
        # hs-embed L2 distance + optimal assignment. The JAX package solves
        # the full (S, Q) problem with BIG costs outside inactive x kept;
        # its optimum on those entries is the rectangular optimum of that
        # submatrix, which is what is solved here.
        diff = state.hs[:, None] - det_hs[None].to(state.hs.dtype)
        dist = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        rows = inact.nonzero()[:, 0]
        cols = det_keep.nonzero()[:, 0]
        col4row = hungarian_rect(dist[rows][:, cols])
        matched = col4row >= 0
        revive_det = torch.full((s,), -1, dtype=torch.long, device=dev)
        revive_det[rows[matched]] = cols[col4row[matched]]
        pair_d = dist.gather(1, revive_det.clamp(min=0)[:, None])[:, 0]
        revive_det = torch.where(
            (revive_det >= 0) & (pair_d <= cfg.reid_sim_threshold),
            revive_det, -1)

    reviving = revive_det >= 0
    det_idx = revive_det.clamp(0, det_boxes.shape[0] - 1)
    state = state.replace(
        boxes=torch.where(reviving[:, None], det_boxes[det_idx], state.boxes),
        scores=torch.where(reviving, det_scores[det_idx], state.scores),
        hs=torch.where(reviving[:, None], det_hs[det_idx].to(state.hs.dtype),
                       state.hs),
        count_inactive=torch.where(reviving, 0, state.count_inactive),
        active=state.active | reviving,
        inactive=state.inactive & ~reviving,
        num_reids=state.num_reids + reviving.sum(),
        masks=(state.masks if state.masks is None or det_masks is None
               else torch.where(reviving[:, None, None], det_masks[det_idx],
                                state.masks)))
    # detections consumed by reid are removed
    consumed = torch.zeros(det_keep.shape, dtype=torch.long, device=dev)
    consumed.index_put_((det_idx,), reviving.long(), accumulate=True)
    return state, det_keep & (consumed == 0)


def _prepare_track_queries(state: TrackerState, orig_size: torch.Tensor,
                           cfg: TrackerConfig):
    """Prune, then build the track-query inputs. orig_size: (2,) (h, w)."""
    state = _prune_inactive(state, cfg)
    live = state.active | state.inactive
    h, w = orig_size[0].float(), orig_size[1].float()
    scale = torch.stack([w, h, w, h])
    tq_boxes = box_ops.box_xyxy_to_cxcywh(state.boxes / scale)
    return state, state.hs, tq_boxes, live


def _track_logic(state: TrackerState, boxes_all, scores_all, labels_all,
                 hs_all, public_boxes, public_valid, hw, cfg: TrackerConfig,
                 masks_all=None, attn_all=None):
    """All post-model track logic for one sequence; `masks_all` (S + Q, Hm,
    Wm) mask probabilities and `attn_all` (S + Q, Ha, Wa) attention maps,
    or None. A revived track keeps the attention map it had."""
    s = cfg.max_tracks
    h, w = hw[0], hw[1]
    if not cfg.overflow_boxes:
        boxes_all = box_ops.clip_boxes_to_image(boxes_all, (h, w))

    # --- existing tracks ---
    t_scores, t_boxes = scores_all[:s], boxes_all[:s]
    t_labels, t_hs = labels_all[:s], hs_all[:s]
    keep = (t_scores > cfg.track_obj_score_thresh) & (t_labels == 0) \
        & state.active
    ct = torch.where(keep, 0, state.count_term + (state.active & ~keep))
    to_inactive = state.active & ~keep & (ct >= cfg.steps_termination)
    rk = (t_scores > cfg.reid_score_thresh) & (t_labels == 0) \
        & state.inactive
    upd = keep | rk
    state = state.replace(
        boxes=torch.where(upd[:, None], t_boxes, state.boxes),
        scores=torch.where(upd, t_scores, state.scores),
        hs=torch.where(upd[:, None], t_hs.to(state.hs.dtype), state.hs),
        count_term=ct,
        active=(state.active & ~to_inactive) | rk,
        inactive=(state.inactive | to_inactive) & ~rk,
        num_reids=state.num_reids + rk.sum(),
        masks=(state.masks if masks_all is None else
               torch.where(upd[:, None, None], masks_all[:s], state.masks)),
        attn_maps=(state.attn_maps if attn_all is None else
                   torch.where(upd[:, None, None], attn_all[:s],
                               state.attn_maps)))

    # --- track NMS: suppressed slots are freed ---
    if cfg.track_nms_thresh:
        keep_nms = nms_mask(state.boxes, state.scores, state.active,
                            cfg.track_nms_thresh)
        removed = state.active & ~keep_nms
        state = state.replace(active=state.active & keep_nms,
                              ids=torch.where(removed, -1, state.ids))

    # --- new detections ---
    d_scores, d_boxes = scores_all[s:], boxes_all[s:]
    d_labels, d_hs = labels_all[s:], hs_all[s:]
    d_masks = None if masks_all is None else masks_all[s:]
    d_keep = (d_scores > cfg.detection_obj_score_thresh) & (d_labels == 0)
    d_keep = _public_detections_mask(cfg, d_boxes, d_keep, public_boxes,
                                     public_valid)
    state, d_keep = _reid(state, d_boxes, d_scores, d_hs, d_masks, d_keep,
                          cfg)
    state, new_track_mask = _scatter_new_tracks(
        state, d_keep, d_boxes, d_scores, d_hs, d_masks, cfg,
        None if attn_all is None else attn_all[s:])

    # --- detection NMS: old tracks pinned with an infinite score ---
    if cfg.detection_nms_thresh:
        nms_scores = torch.where(new_track_mask, state.scores, torch.inf)
        keep_nms = nms_mask(state.boxes, nms_scores, state.active,
                            cfg.detection_nms_thresh)
        removed = state.active & ~keep_nms
        state = state.replace(active=state.active & keep_nms,
                              ids=torch.where(removed, -1, state.ids))

    # --- per-frame results ---
    res_boxes = state.boxes if cfg.overflow_boxes else \
        box_ops.clip_boxes_to_image(state.boxes, (h, w))
    frame_results = {"ids": torch.where(state.active, state.ids, -1),
                     "boxes": res_boxes, "scores": state.scores,
                     "obj_ind": state.obj_ind}
    if state.masks is not None:
        # overlaps at head resolution: each pixel to the active track of
        # the highest probability
        active = state.active[:, None, None]
        winner = torch.where(active, state.masks, -torch.inf).argmax(0)
        slots = torch.arange(s, device=winner.device)[:, None, None]
        frame_results["masks"] = ((state.masks > 0.5)
                                  & (winner[None] == slots) & active)
    if state.attn_maps is not None:
        frame_results["attention_maps"] = torch.where(
            state.active[:, None, None], state.attn_maps, 0.0)
    state = state.replace(
        count_inactive=state.count_inactive + state.inactive.long())
    if cfg.reid_sim_only:
        state = state.replace(inactive=state.inactive | state.active,
                              active=torch.zeros_like(state.active))
    return state, frame_results


def make_tracker_step(model: Callable, postprocess: Callable,
                      cfg: TrackerConfig, batched: bool = False):
    """The per-frame step. `model(batch, targets, prev_features)` returns
    the model 5-tuple.

    Unbatched (default): step(state, batch (1, H, W, 3), orig_size (1, 2),
    public_boxes (P, 4), public_valid (P,), prev_features) ->
    (state, frame_results, features).

    Batched: step(states, batch (B, H, W, 3), orig_sizes (B, 2),
    public_boxes (B, P, 4), public_valid (B, P), prev_features) ->
    (states, frame_results, features), with a list of B states in and out
    and a list of B result dicts. The model runs once at batch B; the track
    logic, which reads a few scalars back to the host (the NMS fixed point,
    the reid gate and solver), runs per sequence on its slice of the
    batched outputs.

    A two-stage model is refused: it takes no track queries (its decoder
    queries are its top proposals), and the JAX package's `Tracker` fails
    on it with an IndexError (ROADMAP Queue 3)."""
    if getattr(model, "two_stage", False):
        raise NotImplementedError(
            "the tracker does not take a two-stage model: it drops the "
            "track queries, and the JAX package's Tracker raises IndexError "
            "on it (ROADMAP Queue 3)")

    def core(states: List[TrackerState], batch: FrameBatch, orig_sizes,
             public_boxes, public_valid, prev_features):
        prepared = [_prepare_track_queries(st, osz, cfg)
                    for st, osz in zip(states, orig_sizes)]
        states = [p[0] for p in prepared]
        tq_hs, tq_boxes, tq_valid = (torch.stack([p[i] for p in prepared])
                                     for i in (1, 2, 3))
        targets = empty_targets(len(states), 1, tq_hs.device
                                ).with_track_queries(tq_hs, tq_boxes,
                                                     tq_valid)
        out, _, features, _, _ = model(batch, targets, prev_features)
        res = postprocess(out, orig_sizes)
        hw = orig_sizes.float()
        masks_all = (out["pred_masks"].sigmoid()
                     if cfg.with_masks and "pred_masks" in out else None)
        attn_all = out.get("attention_maps")
        new_states, frame_results = [], []
        for i, st in enumerate(states):
            # carrying masks (attention maps) needs the model's and the
            # slots' buffers
            masks = (masks_all[i] if masks_all is not None
                     and st.masks is not None else None)
            attn = (attn_all[i] if attn_all is not None
                    and st.attn_maps is not None else None)
            st, fr = _track_logic(st, res["boxes"][i], res["scores"][i],
                                  res["labels"][i], out["hs_embed"][i],
                                  public_boxes[i], public_valid[i], hw[i],
                                  cfg, masks, attn)
            new_states.append(st)
            frame_results.append(fr)
        return new_states, frame_results, features

    if batched:
        return core

    def step(state, batch: FrameBatch, orig_size, public_boxes, public_valid,
             prev_features):
        states, frame_results, features = core(
            [state], batch, orig_size, public_boxes[None], public_valid[None],
            prev_features)
        return states[0], frame_results[0], features

    return step


class Tracker:
    """Host shell: drives the step over a sequence and accumulates
    MOTChallenge-style results (reset / step / get_results). With
    `attn_stride` (the model an `AttentionMapDETR`, whose `stride` it is)
    every result entry carries its track's "attention_map"."""

    def __init__(self, model: torch.nn.Module, postprocess: Callable,
                 tracker_cfg: dict, hidden_dim: int, num_object_queries: int,
                 overflow_boxes: bool = False, with_masks: bool = False,
                 attn_stride: Optional[int] = None):
        self.cfg = TrackerConfig.from_dict(
            {**tracker_cfg, "num_object_queries": num_object_queries,
             "overflow_boxes": overflow_boxes, "with_masks": with_masks})
        self.hidden_dim = hidden_dim
        self.attn_stride = attn_stride
        self.device = next(model.parameters()).device
        self._step = make_tracker_step(model, postprocess, self.cfg)
        self.reset()

    def reset(self, hard: bool = True) -> None:
        """Start a new sequence: free every slot and forget the previous
        frame (the slots' mask and attention-map buffers are sized at the
        next frame). A hard reset also clears the results, the frame index
        and the re-id count; a soft one (`hard=False`) keeps them, so the
        results go on from the next frame's index, with track ids counted
        from 0 again, as in the JAX package."""
        self.state = init_state(self.cfg.max_tracks, self.hidden_dim,
                                self.device)
        self._prev_features = deque([None], maxlen=self.cfg.prev_frame_dist)
        if hard:
            self.results: Dict[int, Dict[int, dict]] = {}
            self.frame_index = 0
            self.num_reids = 0

    def step(self, blob: dict) -> None:
        """blob: {"batch": FrameBatch (1, H, W, 3), "orig_size": (1, 2)
        (h, w), optional "dets": (P, 4) public detections}. The batch may
        hold numpy arrays or tensors on any device, as a sequence yields
        them; it is moved to the model's device (no copy if already
        there). A mask model's results carry each track's "mask" at the
        mask head's resolution, an attention map model's its
        "attention_map" at the memory's."""
        dev = self.device
        padded = blob["batch"].images.shape[1:3]
        if self.cfg.with_masks and self.state.masks is None:
            self.state = self.state.replace(masks=torch.zeros(
                (self.cfg.max_tracks,) + mask_hw_of(padded), device=dev))
        if self.attn_stride and self.state.attn_maps is None:
            self.state = self.state.replace(attn_maps=torch.zeros(
                (self.cfg.max_tracks,) + attn_hw_of(padded, self.attn_stride),
                device=dev))
        batch = FrameBatch(images=torch.as_tensor(blob["batch"].images,
                                                  device=dev),
                           mask=torch.as_tensor(blob["batch"].mask,
                                                device=dev))
        orig_size = torch.as_tensor(blob["orig_size"], device=dev)
        p_max = 128
        dets = np.asarray(blob.get("dets", np.zeros((0, 4), np.float32)),
                          dtype=np.float32).reshape(-1, 4)[:p_max]
        public_boxes = np.zeros((p_max, 4), np.float32)
        public_valid = np.zeros((p_max,), bool)
        public_boxes[:len(dets)] = dets
        public_valid[:len(dets)] = True

        prev = self._prev_features[0]
        with torch.inference_mode():
            self.state, frame_results, features = self._step(
                self.state, batch, orig_size,
                torch.as_tensor(public_boxes, device=dev),
                torch.as_tensor(public_valid, device=dev), prev)
        self._prev_features.append(features)

        res = {k: v.cpu().numpy() for k, v in frame_results.items()}
        ids = res["ids"]
        for slot in np.nonzero(ids >= 0)[0]:
            tid = int(ids[slot])
            entry = {"bbox": res["boxes"][slot],
                     "score": float(res["scores"][slot]),
                     "obj_ind": int(res["obj_ind"][slot])}
            if "masks" in res:
                entry["mask"] = res["masks"][slot]
            if "attention_maps" in res:
                entry["attention_map"] = res["attention_maps"][slot]
            self.results.setdefault(tid, {})[self.frame_index] = entry
        self.frame_index += 1
        self.num_reids = int(self.state.num_reids)

    def get_results(self) -> Dict[int, Dict[int, dict]]:
        return self.results
