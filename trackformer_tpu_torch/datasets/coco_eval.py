"""COCO-style detection mAP evaluation without pycocotools: boxes and
masks.

The port's own copy of the box and mask paths of `trackformer_tpu/datasets/
coco_eval.py`: COCOeval's matching protocol per (image, category), greedy
score-ordered matching against the ground truth at 10 IoU thresholds with
crowd and ignore handling, 101-point interpolated precision-recall curves,
the area-range and max-detection variants, and the 12 standard statistics.
`segm` matches on mask IoU (RLE through `utils/rle.py`; a crowd ground
truth divides by the detection's area, as pycocotools does) and takes the
masks' areas for the area ranges. The merge of per-process predictions
goes through `torch.distributed` when a process group is initialized.
Keypoint evaluation raises `NotImplementedError` (ROADMAP Queue 1, item
6).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _check_iou_type(iou_type: str) -> None:
    if iou_type == "keypoints":
        raise NotImplementedError("keypoints evaluation is not ported yet "
                                  "(ROADMAP Queue 1, item 8)")
    if iou_type not in ("bbox", "segm"):
        raise ValueError(f"Unknown iou type {iou_type}")


def convert_to_xywh(boxes: np.ndarray) -> np.ndarray:
    """xyxy -> xywh (reference coco_eval.py:169-171)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    return np.stack([boxes[:, 0], boxes[:, 1],
                     boxes[:, 2] - boxes[:, 0],
                     boxes[:, 3] - boxes[:, 1]], 1)


def box_iou_xywh(det: np.ndarray, gt: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    """IoU with crowd handling (intersection over det area for crowd GT)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    dx1, dy1 = det[:, 0], det[:, 1]
    dx2, dy2 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    iy = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = ix * iy
    da = (det[:, 2] * det[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


class CocoEvaluator:
    """Accumulates per-image detections and computes COCO AP statistics
    (`bbox` and `segm`)."""

    def __init__(self, gt_dataset, iou_types: Sequence[str] = ("bbox",)):
        """gt_dataset: CocoDetection-like with `.anns_by_image`."""
        for iou_type in iou_types:
            _check_iou_type(iou_type)
        self.gt = gt_dataset
        self.iou_types = list(iou_types)
        self.predictions: Dict[int, dict] = {}

    def update(self, predictions: Dict[int, dict]) -> None:
        """predictions: {image_id: {'boxes' xyxy, 'scores', 'labels'[,
        'masks' (RLE dicts or (H, W) arrays)]}}."""
        self.predictions.update(predictions)

    def prepare(self, predictions: Dict[int, dict], iou_type: str):
        """The engine's prediction dict as COCO's result list."""
        _check_iou_type(iou_type)
        if iou_type == "segm":
            return self.prepare_for_coco_segmentation(predictions)
        return self.prepare_for_coco_detection(predictions)

    def prepare_for_coco_detection(self, predictions: Dict[int, dict]):
        out = []
        for image_id, pred in predictions.items():
            if not len(pred.get("boxes", ())):
                continue
            boxes = convert_to_xywh(pred["boxes"]).tolist()
            scores = np.asarray(pred["scores"]).tolist()
            labels = np.asarray(pred["labels"]).tolist()
            out.extend({"image_id": image_id, "category_id": labels[k],
                        "bbox": box, "score": scores[k]}
                       for k, box in enumerate(boxes))
        return out

    def prepare_for_coco_segmentation(self, predictions: Dict[int, dict]):
        """Masks as compressed RLE (the port's codec), with their labels and
        scores."""
        from ..utils import rle as rle_codec

        out = []
        for image_id, pred in predictions.items():
            if not len(pred.get("masks", ())):
                continue
            scores = np.asarray(pred["scores"]).tolist()
            labels = np.asarray(pred["labels"]).tolist()
            for k, m in enumerate(pred["masks"]):
                enc = (m if isinstance(m, dict)
                       else rle_codec.encode_mask(np.asarray(m) > 0.5))
                if isinstance(enc.get("counts"), bytes):
                    enc = dict(enc, counts=enc["counts"].decode())
                out.append({"image_id": image_id, "category_id": labels[k],
                            "segmentation": enc, "score": scores[k]})
        return out

    def synchronize_between_processes(self) -> None:
        """Merge the per-process predictions over the process group. A
        failed merge raises: a multi-process eval must not report one
        process's AP."""
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            return
        shards: List[Optional[Dict[int, dict]]] = \
            [None] * dist.get_world_size()
        dist.all_gather_object(shards, self.predictions)
        merged: Dict[int, dict] = {}
        for shard in shards:
            merged.update(shard)
        self.predictions = merged

    def _mask_iou(self, pred, det_idx, anns, g_crowd, img_id):
        """Mask IoU matrix and the detections' mask areas (pycocotools'
        `maskUtils.iou`: a crowd ground truth divides by the detection's
        area)."""
        from ..utils import rle

        img_info = getattr(self.gt, "images", {}).get(img_id, {})
        d_masks = []
        for i in det_idx:
            m = pred["masks"][int(i)]
            d_masks.append(rle.decode_mask(m) if isinstance(m, dict)
                           else np.asarray(m, bool))
        if d_masks:
            h, w = d_masks[0].shape
        else:
            h = img_info.get("height", 1)
            w = img_info.get("width", 1)
        g_masks = [rle.segmentation_to_mask(a["segmentation"], h, w)
                   for a in anns]
        d_area = np.array([m.sum() for m in d_masks], np.float64)
        ious = np.zeros((len(d_masks), len(g_masks)))
        for di, dm in enumerate(d_masks):
            for gj, gm in enumerate(g_masks):
                inter = np.logical_and(dm, gm).sum()
                union = dm.sum() if g_crowd[gj] else \
                    dm.sum() + gm.sum() - inter
                ious[di, gj] = inter / max(union, 1e-12)
        return ious, d_area

    def _evaluate_images(self, cat_id: Optional[int], area_rng, max_det,
                         iou_type: str = "bbox"):
        """Per-image COCOeval-style matching -> flat tp/fp/score arrays."""
        tps, scores, n_gt = [], [], 0
        lo, hi = area_rng
        for img_id, pred in self.predictions.items():
            anns = self.gt.anns_by_image.get(img_id, [])
            if cat_id is not None:
                anns = [a for a in anns if a["category_id"] == cat_id]
            g_boxes = np.array([a["bbox"] for a in anns],
                               np.float64).reshape(-1, 4)
            g_crowd = np.array(
                [a.get("iscrowd", 0) or a.get("ignore", 0) for a in anns],
                np.int64)
            g_area = np.array([a.get("area", b[2] * b[3])
                               for a, b in zip(anns, g_boxes)], np.float64)
            g_ignore = g_crowd.astype(bool) | (g_area < lo) | (g_area > hi)
            order_g = np.argsort(g_ignore, kind="stable")
            anns = [anns[j] for j in order_g]
            g_boxes, g_crowd, g_ignore = (g_boxes[order_g], g_crowd[order_g],
                                          g_ignore[order_g])

            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            all_scores = np.asarray(pred["scores"], np.float64)
            labels = np.asarray(pred["labels"])
            det_idx = np.arange(len(all_scores))
            if cat_id is not None:
                det_idx = det_idx[labels == cat_id]
            order = np.argsort(-all_scores[det_idx], kind="stable")[:max_det]
            det_idx = det_idx[order]
            boxes, d_scores = boxes[det_idx], all_scores[det_idx]
            d_xywh = np.stack([boxes[:, 0], boxes[:, 1],
                               boxes[:, 2] - boxes[:, 0],
                               boxes[:, 3] - boxes[:, 1]], 1) \
                if len(boxes) else boxes
            d_area = d_xywh[:, 2] * d_xywh[:, 3] if len(boxes) else \
                np.zeros(0)

            _check_iou_type(iou_type)
            if iou_type == "segm":
                ious, d_area = self._mask_iou(pred, det_idx, anns, g_crowd,
                                              img_id)
            else:
                ious = box_iou_xywh(d_xywh, g_boxes, g_crowd)
            t = len(IOU_THRS)
            tp = np.zeros((t, len(boxes)), bool)
            d_ig = np.zeros((t, len(boxes)), bool)
            for ti, thr in enumerate(IOU_THRS):
                matched_g = np.zeros(len(g_boxes), bool)
                for di in range(len(boxes)):
                    best, best_j = min(thr, 1 - 1e-10), -1
                    for gj in range(len(g_boxes)):
                        if matched_g[gj] and not g_crowd[gj]:
                            continue
                        if best_j > -1 and not g_ignore[best_j] \
                                and g_ignore[gj]:
                            break
                        if ious[di, gj] < best:
                            continue
                        best, best_j = ious[di, gj], gj
                    if best_j >= 0:
                        matched_g[best_j] = True
                        tp[ti, di] = not g_ignore[best_j]
                        d_ig[ti, di] = g_ignore[best_j]
                # unmatched dets outside area range are ignored
                out_rng = (d_area < lo) | (d_area > hi)
                d_ig[ti] |= (~tp[ti]) & (~d_ig[ti]) & out_rng
            tps.append((tp, d_ig))
            scores.append(d_scores)
            n_gt += int((~g_ignore).sum())
        return tps, scores, n_gt

    def _ap_ar(self, cat_ids, area: str = "all", max_det: int = 100,
               iou_type: str = "bbox", return_curves: bool = False):
        t, r = len(IOU_THRS), len(REC_THRS)
        ap_list, ar_list = [], []
        # COCOeval.eval layout slices: precision/scores are (T, R, K)
        prec_out = np.full((t, r, len(cat_ids)), -1.0)
        score_out = np.full((t, r, len(cat_ids)), -1.0)
        rec_out = np.full((t, len(cat_ids)), -1.0)
        for ci, cat in enumerate(cat_ids):
            tps, scores, n_gt = self._evaluate_images(
                cat, AREA_RANGES[area], max_det, iou_type)
            if n_gt == 0:
                continue
            all_scores = np.concatenate(scores) if scores else np.zeros(0)
            order = np.argsort(-all_scores, kind="mergesort")
            sorted_scores = all_scores[order]
            tp = np.concatenate([t_[0] for t_ in tps], 1)[:, order] \
                if tps else np.zeros((t, 0), bool)
            ig = np.concatenate([t_[1] for t_ in tps], 1)[:, order] \
                if tps else np.zeros((t, 0), bool)
            aps, ars = [], []
            for ti in range(t):
                keep = ~ig[ti]
                t_row = tp[ti][keep]
                s_row = sorted_scores[keep]
                tp_cum = np.cumsum(t_row)
                fp_cum = np.cumsum(~t_row)
                rec = tp_cum / n_gt
                prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
                # monotone precision envelope + 101-pt interpolation
                for i in range(len(prec) - 1, 0, -1):
                    prec[i - 1] = max(prec[i - 1], prec[i])
                idx = np.searchsorted(rec, REC_THRS, side="left")
                q = np.zeros(r)
                qs = np.zeros(r)
                valid = idx < len(prec)
                q[valid] = prec[idx[valid]]
                qs[valid] = s_row[idx[valid]] if len(s_row) else 0.0
                aps.append(q.mean())
                ars.append(rec[-1] if len(rec) else 0.0)
                prec_out[ti, :, ci] = q
                score_out[ti, :, ci] = qs
                rec_out[ti, ci] = rec[-1] if len(rec) else 0.0
            ap_list.append(aps)
            ar_list.append(ars)
        if not ap_list:
            ap = ar = np.full(t, np.nan)
        else:
            ap, ar = np.mean(ap_list, 0), np.mean(ar_list, 0)
        if return_curves:
            return ap, ar, prec_out, score_out, rec_out
        return ap, ar

    def dump_eval(self, path: str, iou_type: str = "bbox",
                  max_det: int = 100) -> None:
        """COCOeval-style precision-recall arrays for offline plotting, as
        an `.npz`: precision and scores of shape (T, R, K, 1, 1) for area
        "all", recall, and `recThrs` (the JAX package's layout)."""
        cat_ids = sorted({a["category_id"]
                          for anns in self.gt.anns_by_image.values()
                          for a in anns})
        _, _, prec, score, rec = self._ap_ar(
            cat_ids, "all", max_det, iou_type, return_curves=True)
        np.savez(path, precision=prec[:, :, :, None, None],
                 scores=score[:, :, :, None, None],
                 recall=rec[:, :, None, None], recThrs=REC_THRS)

    def summarize(self) -> Dict[str, List[float]]:
        """The 12 standard COCO statistics per iou type."""
        cat_ids = sorted({a["category_id"]
                          for anns in self.gt.anns_by_image.values()
                          for a in anns})
        names = ["AP", "AP50", "AP75", "APs", "APm", "APl",
                 "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"]
        out = {}
        for iou_type in self.iou_types:
            ap, _ = self._ap_ar(cat_ids, "all", 100, iou_type)
            stats = [float(np.nanmean(ap)), float(ap[0]), float(ap[5])]
            for area in ("small", "medium", "large"):
                a, _ = self._ap_ar(cat_ids, area, 100, iou_type)
                stats.append(float(np.nanmean(a)))
            for md in (1, 10, 100):
                _, ar = self._ap_ar(cat_ids, "all", md, iou_type)
                stats.append(float(np.nanmean(ar)))
            for area in ("small", "medium", "large"):
                _, ar = self._ap_ar(cat_ids, area, 100, iou_type)
                stats.append(float(np.nanmean(ar)))
            print(f"COCO eval ({iou_type}):")
            for n, s in zip(names, stats):
                print(f"  {n:6s} = {s:.3f}")
            out[iou_type] = stats
        return out
