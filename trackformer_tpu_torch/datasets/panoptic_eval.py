"""Panoptic quality (PQ), without panopticapi.

Counterpart of `trackformer_tpu/datasets/panoptic_eval.py`:
`PanopticEvaluator` writes each prediction's PNG into `output_dir` and
`summarize` matches, image by image, every predicted segment to the ground
truth segment of its category with an IoU over 0.5 (pixel counts of the
two id maps), then averages over the categories PQ = SQ x RQ, SQ the mean
IoU of the matches and RQ = TP / (TP + FP / 2 + FN / 2). A crowd ground
truth segment left unmatched is no false negative. Over several processes
`synchronize_between_processes` gathers every rank's predictions with
their PNGs, so that each rank summarizes all of them.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np
from PIL import Image

from ..models.panoptic import rgb2id
from ..parallel.dist import all_gather_objects, world_size

# a match needs an IoU over this
MATCH_IOU = 0.5


class PanopticEvaluator:
    def __init__(self, ann_file: str, ann_folder: str, output_dir: str):
        self.gt_json = ann_file
        self.gt_folder = Path(ann_folder)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.predictions: List[Dict] = []

    def update(self, predictions: List[Dict]) -> None:
        """Predictions of `postprocess_panoptic` with their "image_id"; each
        PNG goes to `output_dir` (named by the image id unless the
        prediction has a "file_name")."""
        for p in predictions:
            if "png_string" in p:
                fname = p.get("file_name", f"{p['image_id']:012d}.png")
                with open(self.output_dir / fname, "wb") as f:
                    f.write(p.pop("png_string"))
                p["file_name"] = fname
            self.predictions.append(p)

    def synchronize_between_processes(self) -> None:
        """Merge every rank's predictions, writing the PNGs that this
        rank's `output_dir` lacks (each rank may have its own). An image
        that several ranks predicted (tensor-parallel ranks share their
        data) counts once."""
        if world_size() <= 1:
            return
        mine = [(p, (self.output_dir / p["file_name"]).read_bytes())
                for p in self.predictions]
        merged: Dict[int, Dict] = {}
        for shard in all_gather_objects(mine):
            for pred, png in shard:
                if pred["image_id"] in merged:
                    continue
                path = self.output_dir / pred["file_name"]
                if not path.exists():
                    path.write_bytes(png)
                merged[pred["image_id"]] = pred
        self.predictions = list(merged.values())

    def summarize(self) -> Dict[str, float]:
        """-> {"PQ", "SQ", "RQ"}, each averaged over the categories that
        have a match, a false positive or a false negative."""
        with open(self.gt_json) as f:
            gt = json.load(f)
        gt_by_image = {a["image_id"]: a for a in gt["annotations"]}
        pq_stat = defaultdict(lambda: {"iou": 0.0, "tp": 0, "fp": 0,
                                       "fn": 0})
        for pred in self.predictions:
            img_id = pred["image_id"]
            if img_id not in gt_by_image:
                continue
            g = gt_by_image[img_id]
            with Image.open(self.gt_folder / g["file_name"]) as im:
                gt_map = rgb2id(np.asarray(im.convert("RGB")))
            with Image.open(self.output_dir / pred["file_name"]) as im:
                pr_map = rgb2id(np.asarray(im.convert("RGB")))

            gt_segs = {s["id"]: s for s in g["segments_info"]}
            pr_segs = {s["id"]: s for s in pred["segments_info"]}
            # pixel counts of each (gt id, predicted id) pair
            combined = gt_map.astype(np.uint64) * (1 << 32) + pr_map
            ids, counts = np.unique(combined, return_counts=True)
            inter = {(int(i >> 32), int(i & 0xFFFFFFFF)): int(c)
                     for i, c in zip(ids, counts)}
            gt_area = defaultdict(int)
            pr_area = defaultdict(int)
            for (gi, pi), c in inter.items():
                gt_area[gi] += c
                pr_area[pi] += c
            matched_gt, matched_pr = set(), set()
            for (gi, pi), c in inter.items():
                if gi not in gt_segs or pi not in pr_segs:
                    continue
                if gt_segs[gi]["category_id"] != pr_segs[pi]["category_id"]:
                    continue
                union = gt_area[gi] + pr_area[pi] - c
                iou = c / union if union else 0.0
                if iou > MATCH_IOU:
                    cat = gt_segs[gi]["category_id"]
                    pq_stat[cat]["iou"] += iou
                    pq_stat[cat]["tp"] += 1
                    matched_gt.add(gi)
                    matched_pr.add(pi)
            for gi, s in gt_segs.items():
                if gi not in matched_gt and not s.get("iscrowd", 0):
                    pq_stat[s["category_id"]]["fn"] += 1
            for pi, s in pr_segs.items():
                if pi not in matched_pr:
                    pq_stat[s["category_id"]]["fp"] += 1

        pqs, sqs, rqs = [], [], []
        for st in pq_stat.values():
            denom = st["tp"] + 0.5 * st["fp"] + 0.5 * st["fn"]
            if denom == 0:
                continue
            sq = st["iou"] / max(st["tp"], 1)
            rq = st["tp"] / denom
            pqs.append(sq * rq)
            sqs.append(sq)
            rqs.append(rq)
        result = {
            "PQ": float(np.mean(pqs)) if pqs else 0.0,
            "SQ": float(np.mean(sqs)) if sqs else 0.0,
            "RQ": float(np.mean(rqs)) if rqs else 0.0,
        }
        print("Panoptic:", result)
        return result
