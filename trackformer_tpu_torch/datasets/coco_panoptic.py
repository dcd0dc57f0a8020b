"""COCO panoptic dataset.

Counterpart of `trackformer_tpu/datasets/coco_panoptic.py`. A panoptic PNG
encodes each pixel's segment id as RGB (id = R + 256 G + 256^2 B); a
sample's masks are decoded from it per segment, and its boxes derived
from the masks. The images are read with Pillow as float32 in [0, 1], as
in the JAX package. For box and mask AP during panoptic training the
dataset is a COCO detection facade too (`anns_by_image`, `images`): each
segment is an annotation, and its mask RLE is decoded from the PNG only
when an image's annotations are fetched (`_LazySegmAnns`).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image

from ..models.panoptic import rgb2id
from .coco import split_transforms


class _LazySegmAnns(dict):
    """`anns_by_image` of `CocoPanoptic`: each image's annotations from its
    `segments_info`, their `segmentation` RLEs decoded from the panoptic PNG
    when the image's list is first fetched (`get`, `[]`); iterating the
    dict decodes nothing."""

    def __init__(self, dataset):
        super().__init__()
        self._dataset = dataset
        self.files = {}
        self._decoded = set()

    def _ensure_segm(self, key):
        if key in self._decoded or key not in self.files:
            return
        self._decoded.add(key)
        from ..utils import rle as rle_mod
        path = self._dataset.ann_folder / self.files[key]
        with Image.open(path) as m:
            pan = rgb2id(np.asarray(m.convert("RGB")))
        for a in dict.__getitem__(self, key):
            a["segmentation"] = rle_mod.encode_mask(pan == a["segment_id"])

    def __getitem__(self, key):
        self._ensure_segm(key)
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        if key not in self:
            return default
        return self[key]


class CocoPanoptic:
    def __init__(self, img_folder, ann_folder, ann_file, transforms,
                 norm_transforms, return_masks: bool = True):
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.coco["images"] = sorted(self.coco["images"],
                                     key=lambda x: x["id"])
        self.img_folder = Path(img_folder)
        self.ann_folder = Path(ann_folder)
        self.ann_file = Path(ann_file)
        self._transforms = transforms
        self._norm_transforms = norm_transforms
        self.return_masks = return_masks
        self.anns = self.coco["annotations"]
        self.images = {im["id"]: im for im in self.coco["images"]}
        self.anns_by_image = _LazySegmAnns(self)
        aid = 0
        for ann in self.anns:
            lst = []
            for s in ann["segments_info"]:
                bbox = [float(v) for v in s.get("bbox", (0, 0, 0, 0))]
                lst.append({
                    "id": aid, "image_id": ann["image_id"],
                    "segment_id": s["id"],
                    "category_id": s["category_id"], "bbox": bbox,
                    "area": float(s.get("area", bbox[2] * bbox[3])),
                    "iscrowd": int(s.get("iscrowd", 0)), "ignore": 0})
                aid += 1
            dict.__setitem__(self.anns_by_image, ann["image_id"], lst)
            self.anns_by_image.files[ann["image_id"]] = ann["file_name"]

    def __len__(self):
        return len(self.anns)

    def __getitem__(self, idx):
        """-> {"image", "target"}: the image and its segments as the
        detection targets (0-based labels, xyxy boxes of the masks, then
        the transforms and Normalize); the transforms draw from a seed of
        the global numpy RNG, as in the JAX package."""
        ann_info = self.anns[idx]
        img_path = self.img_folder / ann_info["file_name"].replace(
            ".png", ".jpg")
        with Image.open(img_path) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
        h, w = img.shape[:2]

        with Image.open(self.ann_folder / ann_info["file_name"]) as m:
            pan = rgb2id(np.asarray(m.convert("RGB")))
        ids = np.array([s["id"] for s in ann_info["segments_info"]])
        masks = pan[None] == ids[:, None, None]

        boxes = []
        for mk in masks:
            ys, xs = np.nonzero(mk)
            if len(ys):
                boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
            else:
                boxes.append([0, 0, 0, 0])
        segs = ann_info["segments_info"]
        target = {
            "image_id": np.int64(ann_info["image_id"]),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray([s["category_id"] - 1 for s in segs],
                                 np.int64),
            "masks": masks.astype(bool),
            "area": np.asarray([s["area"] for s in segs], np.float32),
            "iscrowd": np.asarray([s["iscrowd"] for s in segs], np.int64),
            "track_ids": np.arange(len(boxes), dtype=np.int64),
            "ignore": np.zeros(len(boxes), bool),
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
        }
        rng = np.random.default_rng(np.random.randint(0, 2**31 - 1))
        if self._transforms is not None:
            img, target = self._transforms(img, target, rng)
        target.pop("ignore", None)
        img, target = self._norm_transforms(img, target, rng)
        return {"image": img, "target": target}


def build_coco_panoptic(image_set: str, args):
    root = Path(args.coco_path)
    pan_root = Path(args.coco_panoptic_path)
    split = args.train_split if image_set == "train" else args.val_split
    return CocoPanoptic(root / f"{split}2017",
                        pan_root / f"panoptic_{split}2017",
                        pan_root / "annotations" / f"panoptic_{split}2017.json",
                        *split_transforms(image_set, args),
                        return_masks=args.masks)
