"""Tracking evaluation glue and offline track utilities.

The port's own copy of the numpy part of `trackformer_tpu/utils/
track_utils.py`: `get_mot_accum` builds a per-sequence accumulator from a
tracker's results and the sequence's ground truth, `evaluate_mot_accums`
summarizes and prints them, `interpolate_tracks` fills frame gaps inside
each track. `upscale_mask_results`, `plot_sequence` and `write_video` wait
for masks and visualisation (ROADMAP Queue 1, items 6 and 8).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .mot_metrics import (MOTAccumulator, format_summary, iou_distance,
                          summarize)


def get_mot_accum(results: Dict[int, Dict[int, dict]],
                  seq) -> MOTAccumulator:
    """Build a per-frame accumulator from tracker results and sequence GT."""
    acc = MOTAccumulator(name=str(seq))
    for frame_idx in range(len(seq)):
        frame_data = seq.data[frame_idx] if hasattr(seq, "data") else \
            {"gt": {}}
        gt = frame_data.get("gt", {})
        gt_ids = list(gt.keys())
        gt_boxes = np.asarray([gt[i] for i in gt_ids],
                              np.float32).reshape(-1, 4)

        hyp_ids = []
        hyp_boxes = []
        for tid, track in results.items():
            if frame_idx in track:
                hyp_ids.append(tid)
                hyp_boxes.append(np.asarray(track[frame_idx]["bbox"][:4]))
        hyp_boxes = np.asarray(hyp_boxes, np.float32).reshape(-1, 4)

        dist = iou_distance(gt_boxes, hyp_boxes)
        acc.update(gt_ids, hyp_ids, dist)
    return acc


def evaluate_mot_accums(accums: List[MOTAccumulator],
                        names: Optional[List[str]] = None,
                        generate_overall: bool = True) -> Dict:
    summary = summarize(accums, names, generate_overall)
    print(format_summary(summary))
    return summary


def interpolate_tracks(tracks: Dict[int, Dict[int, dict]]) -> Dict:
    """Linearly fill frame gaps inside each track (reference :239-271 —
    which returns after the first track; fixed here)."""
    interpolated: Dict[int, Dict[int, dict]] = {}
    for tid, track in tracks.items():
        interpolated[tid] = {}
        frames = sorted(track.keys())
        if not frames:
            continue
        for f in frames:
            interpolated[tid][f] = track[f]
        for a, b in zip(frames[:-1], frames[1:]):
            if b - a <= 1:
                continue
            box_a = np.asarray(track[a]["bbox"][:4], np.float64)
            box_b = np.asarray(track[b]["bbox"][:4], np.float64)
            for f in range(a + 1, b):
                t = (f - a) / (b - a)
                interpolated[tid][f] = {
                    "bbox": (box_a * (1 - t) + box_b * t).astype(np.float32),
                    "score": track[a].get("score", 1.0),
                }
    return interpolated
