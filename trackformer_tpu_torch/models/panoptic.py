"""Panoptic postprocessing, on the host in numpy and Pillow.

Counterpart of `trackformer_tpu/models/panoptic.py`, kept as the same
host code so that the PNG bytes and the segment areas come out equal:
`id2rgb` / `rgb2id` (segment id = R + 256 G + 256^2 B) and
`postprocess_panoptic`, which keeps the queries whose softmax score
passes `threshold` and whose argmax is not the last (no-object) column,
resizes their mask logits to the processed size (Pillow, bilinear, float32),
gives each pixel to the query of the highest logit (numpy's argmax: the
lower query first among ties), merges the stuff segments of one class,
drops segments of at most 4 pixels until none is left, and writes the ids
as an RGB PNG resized to the target size (Pillow, nearest).

The softmax runs over every column, the last included, whatever head the
model has: on a focal (sigmoid) model it is a softmax over logits that
have no no-object column, as in the JAX package (ROADMAP Queue 3).
"""
from __future__ import annotations

import io
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

# segments of at most this many pixels are dropped
SMALL_SEGMENT = 4


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    rgb = np.zeros(id_map.shape + (3,), np.uint8)
    for i in range(3):
        rgb[..., i] = (id_map >> (8 * i)) & 255
    return rgb


def rgb2id(color: np.ndarray) -> np.ndarray:
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 65536 * color[..., 2]


def postprocess_panoptic(outputs: Dict, processed_sizes: List,
                         is_thing_map: Dict[int, bool],
                         target_sizes: Optional[List] = None,
                         threshold: float = 0.85) -> List[Dict]:
    """outputs: "pred_logits" (B, Q, C + 1) and "pred_masks" (B, Q, h, w)
    float32 numpy arrays (or CPU float32 tensors). `processed_sizes` and
    `target_sizes` (default: the processed ones) are (h, w) per image.
    Returns per image {"png_string", "segments_info"}; a segment's
    "category_id" is its argmax column."""
    logits = np.asarray(outputs["pred_logits"])
    raw_masks = np.asarray(outputs["pred_masks"])
    target_sizes = target_sizes or processed_sizes
    preds = []
    for b in range(logits.shape[0]):
        lg = logits[b]
        e = np.exp(lg - lg.max(-1, keepdims=True))
        prob = e / e.sum(-1, keepdims=True)
        scores = prob.max(-1)
        labels = prob.argmax(-1)
        keep = (labels != lg.shape[-1] - 1) & (scores > threshold)

        cur_scores = scores[keep]
        cur_classes = labels[keep]
        size = tuple(int(v) for v in processed_sizes[b])
        masks = raw_masks[b][keep]
        resized = np.stack([
            np.asarray(Image.fromarray(m).resize(
                (size[1], size[0]), Image.BILINEAR)) for m in masks]) \
            if len(masks) else np.zeros((0,) + size, np.float32)

        h, w = size
        stuff_equiv = defaultdict(list)
        for k, lab in enumerate(cur_classes):
            if not is_thing_map.get(int(lab), True):
                stuff_equiv[int(lab)].append(k)

        def get_ids_area(msk, dedup=False):
            if len(msk) == 0:
                m_id = np.zeros((h, w), np.int64)
            else:
                m_id = msk.reshape(len(msk), -1).argmax(0).reshape(h, w)
            if dedup:
                for equiv in stuff_equiv.values():
                    if len(equiv) > 1:
                        for eid in equiv:
                            m_id[m_id == eid] = equiv[0]
            fh, fw = (int(v) for v in target_sizes[b])
            seg_img = Image.fromarray(id2rgb(m_id)).resize(
                (fw, fh), Image.NEAREST)
            m_id_final = rgb2id(np.asarray(seg_img))
            area = [int((m_id_final == i).sum()) for i in range(len(msk))]
            return area, seg_img

        area, seg_img = get_ids_area(resized, dedup=True)
        if len(cur_classes):
            while True:
                small = np.array([a <= SMALL_SEGMENT for a in area], bool)
                if small.any():
                    cur_scores = cur_scores[~small]
                    cur_classes = cur_classes[~small]
                    resized = resized[~small]
                    area, seg_img = get_ids_area(resized)
                else:
                    break
        else:
            cur_classes = np.ones(1, np.int64)

        segments_info = [
            {"id": i, "isthing": is_thing_map.get(int(c), True),
             "category_id": int(c), "area": a}
            for i, (a, c) in enumerate(zip(area, cur_classes))]
        with io.BytesIO() as out:
            seg_img.save(out, format="PNG")
            preds.append({"png_string": out.getvalue(),
                          "segments_info": segments_info})
    return preds
