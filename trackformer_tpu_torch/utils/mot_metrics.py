"""CLEAR-MOT and identity metrics (MOTA, MOTP, IDF1, MT/ML, FP/FN/IDSW).

The port's own copy of `trackformer_tpu/utils/mot_metrics.py`, on numpy and
scipy (py-motmetrics is not a dependency):
  * per-frame association with carry-over of previous matches and Hungarian
    assignment on IoU distance (cutoff 0.5), motmetrics' MOTAccumulator
    semantics;
  * CLEAR metrics from event counts;
  * ID measures (IDF1/IDP/IDR) via the global trajectory assignment of
    Ristani et al. 2016.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def iou_distance(gt_boxes: np.ndarray, hyp_boxes: np.ndarray,
                 max_iou: float = 0.5) -> np.ndarray:
    """1 - IoU on xyxy boxes; entries with IoU < 1 - max_iou -> NaN
    (forbidden), matching motmetrics.distances.iou_matrix semantics."""
    if len(gt_boxes) == 0 or len(hyp_boxes) == 0:
        return np.zeros((len(gt_boxes), len(hyp_boxes)))
    a = gt_boxes[:, None]
    b = hyp_boxes[None, :]
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[..., 2] - a[..., 0], 0, None) * \
        np.clip(a[..., 3] - a[..., 1], 0, None)
    area_b = np.clip(b[..., 2] - b[..., 0], 0, None) * \
        np.clip(b[..., 3] - b[..., 1], 0, None)
    union = area_a + area_b - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    dist = 1.0 - iou
    dist[dist > max_iou] = np.nan
    return dist


class MOTAccumulator:
    """Frame-by-frame event accumulator (motmetrics-compatible logic)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.events: List[dict] = []  # per frame lists
        self._last_match: Dict = {}  # gt id -> hyp id (persisting pairing)
        self._gt_frames: Dict = {}  # gt id -> set of frames present
        self._gt_matched_frames: Dict = {}
        self.frames = 0

    def update(self, gt_ids: Sequence, hyp_ids: Sequence,
               dist: np.ndarray) -> None:
        gt_ids = list(gt_ids)
        hyp_ids = list(hyp_ids)
        dist = np.asarray(dist, float).reshape(len(gt_ids), len(hyp_ids))
        frame = self.frames
        self.frames += 1

        matches = {}  # gt -> hyp this frame
        used_h = set()

        # 1. carry over previous pairings still valid
        for i, g in enumerate(gt_ids):
            h = self._last_match.get(g)
            if h is not None and h in hyp_ids:
                j = hyp_ids.index(h)
                if np.isfinite(dist[i, j]):
                    matches[g] = h
                    used_h.add(h)

        # 2. Hungarian on the remainder
        rem_g = [i for i, g in enumerate(gt_ids) if g not in matches]
        rem_h = [j for j, h in enumerate(hyp_ids) if h not in used_h]
        if rem_g and rem_h:
            sub = dist[np.ix_(rem_g, rem_h)]
            big = 1e9
            cost = np.where(np.isfinite(sub), sub, big)
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if np.isfinite(sub[r, c]):
                    g, h = gt_ids[rem_g[r]], hyp_ids[rem_h[c]]
                    matches[g] = h
                    used_h.add(h)

        ev = {"match": [], "switch": [], "fp": [], "miss": [], "dist": []}
        for i, g in enumerate(gt_ids):
            self._gt_frames.setdefault(g, set()).add(frame)
            if g in matches:
                h = matches[g]
                prev = self._last_match.get(g)
                if prev is not None and prev != h:
                    ev["switch"].append((g, h))
                else:
                    ev["match"].append((g, h))
                self._last_match[g] = h
                self._gt_matched_frames.setdefault(g, set()).add(frame)
                ev["dist"].append(dist[i, hyp_ids.index(h)])
            else:
                ev["miss"].append(g)
        for h in hyp_ids:
            if h not in used_h:
                ev["fp"].append(h)
        ev["gt_ids"] = gt_ids
        ev["hyp_ids"] = hyp_ids
        ev["matches"] = dict(matches)
        self.events.append(ev)


def clear_mot_metrics(accums: Sequence[MOTAccumulator]) -> Dict[str, float]:
    num_gt = num_fp = num_miss = num_switch = num_match = 0
    dist_sum = 0.0
    mt = ml = pt = 0
    num_obj_frames = 0
    for acc in accums:
        for ev in acc.events:
            num_gt += len(ev["gt_ids"])
            num_fp += len(ev["fp"])
            num_miss += len(ev["miss"])
            num_switch += len(ev["switch"])
            num_match += len(ev["match"])
            dist_sum += float(np.nansum(ev["dist"]))
        for g, frames in acc._gt_frames.items():
            ratio = len(acc._gt_matched_frames.get(g, ())) / len(frames)
            num_obj_frames += 1
            if ratio >= 0.8:
                mt += 1
            elif ratio <= 0.2:
                ml += 1
            else:
                pt += 1
    matched_total = num_match + num_switch
    mota = 1.0 - (num_fp + num_miss + num_switch) / max(num_gt, 1)
    motp = dist_sum / max(matched_total, 1)
    return {
        "mota": mota,
        "motp": motp,
        "num_false_positives": num_fp,
        "num_misses": num_miss,
        "num_switches": num_switch,
        "num_matches": num_match,
        "num_objects": num_gt,
        "mostly_tracked": mt,
        "mostly_lost": ml,
        "partially_tracked": pt,
    }


def id_metrics(accums: Sequence[MOTAccumulator]) -> Dict[str, float]:
    """IDF1/IDP/IDR via global min-cost trajectory matching
    (Ristani et al., "Performance Measures and a Data Set for Multi-Target
    Multi-Camera Tracking")."""
    idtp = 0
    total_gt = 0
    total_hyp = 0
    for acc in accums:
        gt_len: Dict = {}
        hyp_len: Dict = {}
        overlap: Dict = {}
        for ev in acc.events:
            for g in ev["gt_ids"]:
                gt_len[g] = gt_len.get(g, 0) + 1
            for h in ev["hyp_ids"]:
                hyp_len[h] = hyp_len.get(h, 0) + 1
            for g, h in ev["matches"].items():
                overlap[(g, h)] = overlap.get((g, h), 0) + 1
        gts = list(gt_len)
        hyps = list(hyp_len)
        ng, nh = len(gts), len(hyps)
        n = ng + nh
        if n == 0:
            continue
        # cost[i, j] = misses + false positives if gt i is assigned to hyp j;
        # gt i may instead pair with its private "unmatched" column nh+i
        # (cost = its full length), symmetrically for hypotheses.
        big = 1e9
        cost = np.full((n, n), 0.0)
        for i, g in enumerate(gts):
            for j, h in enumerate(hyps):
                ov = overlap.get((g, h), 0)
                cost[i, j] = (gt_len[g] - ov) + (hyp_len[h] - ov)
            # unmatched gt i: all its frames are misses
            cost[i, nh:] = big
            cost[i, nh + i] = gt_len[g]
        for j, h in enumerate(hyps):
            cost[ng:, j] = big
            cost[ng + j, j] = hyp_len[h]
        cost[ng:, nh:] = 0.0
        rows, cols = linear_sum_assignment(cost)
        for r, c in zip(rows, cols):
            if r < ng and c < nh:
                idtp += overlap.get((gts[r], hyps[c]), 0)
        total_gt += sum(gt_len.values())
        total_hyp += sum(hyp_len.values())
    idp = idtp / max(total_hyp, 1)
    idr = idtp / max(total_gt, 1)
    idf1 = 2 * idtp / max(total_gt + total_hyp, 1)
    return {"idf1": idf1, "idp": idp, "idr": idr}


def summarize(accums: Sequence[MOTAccumulator],
              names: Optional[Sequence[str]] = None,
              generate_overall: bool = True) -> Dict[str, Dict[str, float]]:
    """Per-sequence + OVERALL summary (reference track.py:197-203 prints the
    motmetrics summary table; same metric keys here)."""
    out = {}
    for acc in accums:
        m = clear_mot_metrics([acc])
        m.update(id_metrics([acc]))
        out[acc.name or f"seq{len(out)}"] = m
    if generate_overall and len(accums) > 0:
        m = clear_mot_metrics(accums)
        m.update(id_metrics(accums))
        out["OVERALL"] = m
    return out


def format_summary(summary: Dict[str, Dict[str, float]]) -> str:
    cols = ["idf1", "mota", "motp", "num_false_positives", "num_misses",
            "num_switches", "mostly_tracked", "mostly_lost"]
    header = f"{'':24s}" + "".join(f"{c[:12]:>14s}" for c in cols)
    lines = [header]
    for name, m in summary.items():
        row = f"{name:24s}"
        for c in cols:
            v = m.get(c, float('nan'))
            row += (f"{v:14.1%}" if c in ("idf1", "mota") else
                    f"{v:14.3f}" if c == "motp" else f"{v:14.0f}")
        lines.append(row)
    return "\n".join(lines)
