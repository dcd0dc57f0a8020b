"""COCO-style detection dataset (plain JSON, no pycocotools).

Counterpart of `trackformer_tpu/datasets/coco.py`: `_getitem_from_id`
with the seed replay that gives a frame and its (simulated) previous frame
the same base augmentation, the synthetic previous-frame jitter crop, the
previous frame, the annotations' conversion with the `ignore` ones split
off, `sample_weights`, and `build_coco`.

Images load through `image_io.read_frame` (Pillow) as float32 HWC in
[0, 1]; targets are numpy dicts of ragged arrays that
`builder.collate_fn` pads into fixed-shape `Targets`. With `return_masks`
each annotation's segmentation (polygons or RLE, `utils/rle.py`) becomes an
(H, W) bool mask. For three-frame training (`prev_prev_frame`) a sample
also holds a previous-previous frame, drawn as the previous frame is from
the same seed: the JAX package's, a copy of the previous frame.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..utils import rle
from . import transforms as T
from .image_io import read_frame

FIELDS = ("boxes", "labels", "area", "iscrowd", "track_ids", "masks")


class CocoDetection:
    def __init__(self, img_folder, ann_file, transforms, norm_transforms,
                 prev_frame: bool = False, prev_frame_rnd_augs: float = 0.0,
                 prev_prev_frame: bool = False, return_masks: bool = False,
                 min_num_objects: int = 0, overflow_boxes: bool = False,
                 remove_no_obj_imgs: bool = False):
        self.root = Path(img_folder)
        self._transforms = transforms
        self._norm_transforms = norm_transforms
        self.return_masks = return_masks
        self.overflow_boxes = overflow_boxes
        self._prev_frame = prev_frame
        self._prev_frame_rnd_augs = prev_frame_rnd_augs
        self._prev_prev_frame = prev_prev_frame

        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image: Dict[int, List[dict]] = {
            im_id: [] for im_id in self.images}
        for ann in coco.get("annotations", []):
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.cats = {c["id"]: c for c in coco.get("categories", [])}

        ids = sorted(self.images.keys())
        if remove_no_obj_imgs:
            ids = sorted({ann["image_id"]
                          for ann in coco.get("annotations", [])})
        if min_num_objects:
            ids = [i for i in ids
                   if len(self.anns_by_image.get(i, [])) >= min_num_objects]
        self.ids = ids
        # sequence metadata (present in converted MOT jsons)
        self.frames_info = {
            i: dict(frame_id=self.images[i].get("frame_id"),
                    seq_length=self.images[i].get("seq_length"),
                    first_frame_image_id=self.images[i].get(
                        "first_frame_image_id"))
            for i in self.ids}

    def __len__(self):
        return len(self.ids)

    @property
    def sample_weights(self) -> np.ndarray:
        """1 / seq_length per sample, so that each sequence counts equally;
        uniform without sequence info."""
        w = []
        for i in self.ids:
            sl = self.frames_info[i].get("seq_length")
            w.append(1.0 / sl if sl else 1.0)
        return np.asarray(w, np.float64)

    def _load_image(self, image_id: int) -> np.ndarray:
        path = self.root / self.images[image_id]["file_name"]
        return read_frame(path).astype(np.float32) / 255.0

    def _prepare(self, image_id: int, img: np.ndarray) -> Dict:
        """The image's annotations as absolute xyxy boxes clipped to the
        image (unless `overflow_boxes`), 0-based labels, areas, crowd and
        ignore flags, track ids (their index when none is given) and, with
        `return_masks`, the (N, H, W) masks."""
        h, w = img.shape[:2]
        anns = [a for a in self.anns_by_image.get(image_id, [])
                if a.get("iscrowd", 0) == 0 or a.get("ignore", 0)]
        boxes, labels, areas, iscrowd, track_ids, ignore, masks = \
            [], [], [], [], [], [], []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            x0, y0 = x, y
            x1, y1 = x + bw, y + bh
            if not self.overflow_boxes:
                x0, y0 = max(0, x0), max(0, y0)
                x1, y1 = min(w, x1), min(h, y1)
            if x1 <= x0 or y1 <= y0:
                continue
            boxes.append([x0, y0, x1, y1])
            labels.append(a["category_id"] - 1 if self.cats else 0)
            areas.append(a.get("area", (x1 - x0) * (y1 - y0)))
            iscrowd.append(a.get("iscrowd", 0))
            track_ids.append(a.get("track_id", -1))
            ignore.append(a.get("ignore", 0))
            if self.return_masks:
                segm = a.get("segmentation")
                masks.append(rle.segmentation_to_mask(segm, h, w)
                             if segm else np.zeros((h, w), bool))

        target = {
            "image_id": np.int64(image_id),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "area": np.asarray(areas, np.float32),
            "iscrowd": np.asarray(iscrowd, np.int64),
            "track_ids": np.asarray(track_ids, np.int64),
            "ignore": np.asarray(ignore, bool),
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
        }
        if all(t == -1 for t in target["track_ids"]):
            target["track_ids"] = np.arange(len(labels), dtype=np.int64)
        if self.return_masks:
            target["masks"] = (np.asarray(masks, bool) if masks
                               else np.zeros((0, h, w), bool))
        return target

    def _getitem_from_id(self, idx: int, seed: int,
                         random_jitter: bool = True):
        image_id = self.ids[idx]
        img = self._load_image(image_id)
        target = self._prepare(image_id, img)

        rng = np.random.default_rng(seed)
        if self._transforms is not None:
            img, target = self._transforms(img, target, rng)

        # split off the ignored annotations
        ignore = target.pop("ignore", np.zeros(0, bool))
        if len(ignore):
            keep = ~ignore
            for f in FIELDS:
                if f in target and target[f] is not None and len(target[f]):
                    target[f + "_ignore"] = target[f][ignore]
                    target[f] = target[f][keep]

        if random_jitter and self._prev_frame_rnd_augs:
            img, target = self._add_random_jitter(img, target, rng)
        img, target = self._norm_transforms(img, target, rng)
        return img, target

    def _add_random_jitter(self, img, target, rng):
        """Synthetic inter-frame motion: a random crop resized back."""
        h, w = img.shape[:2]
        crop_w = int(rng.integers(int((1 - self._prev_frame_rnd_augs) * w),
                                  w + 1))
        crop_h = int(h * crop_w / w)
        top = int(rng.integers(0, h - crop_h + 1))
        left = int(rng.integers(0, w - crop_w + 1))
        img, target = T.crop(img, target, (top, left, crop_h, crop_w),
                             self.overflow_boxes)
        return T.resize(img, target, (h, w))

    def __getitem__(self, idx: int) -> Dict:
        # the global numpy RNG, as the JAX package draws it: the same
        # np.random.seed gives the same samples in both
        seed = int(np.random.randint(0, 2**31 - 1))
        img, target = self._getitem_from_id(idx, seed, random_jitter=False)
        sample = {"image": img, "target": target}
        if self._prev_frame:
            # same seed -> identical base augmentation + independent jitter
            prev_img, prev_target = self._getitem_from_id(idx, seed)
            sample["prev_image"] = prev_img
            sample["prev_target"] = prev_target
            if self._prev_prev_frame:
                pp_img, pp_target = self._getitem_from_id(idx, seed)
                sample["prev_prev_image"] = pp_img
                sample["prev_prev_target"] = pp_target
        return sample


def split_transforms(image_set: str, args):
    """(`make_coco_transforms` without its last step, Normalize): the
    datasets normalize after the jitter."""
    transforms = T.make_coco_transforms(image_set, args.img_transform,
                                        args.overflow_boxes)
    transforms.transforms = transforms.transforms[:-1]
    return transforms, T.Normalize()


def build_coco(image_set: str, args, mode: str = "instances"):
    root = Path(args.coco_path)
    split = args.train_split if image_set == "train" else args.val_split
    ann_file = root / "annotations" / f"{mode}_{split}2017.json"
    img_folder = root / f"{split}2017"
    prev_frame_rnd_augs = (args.coco_and_crowdhuman_prev_frame_rnd_augs
                           if image_set == "train" else 0.0)
    return CocoDetection(
        img_folder, ann_file, *split_transforms(image_set, args),
        prev_frame=args.tracking,
        prev_frame_rnd_augs=prev_frame_rnd_augs,
        prev_prev_frame=args.track_prev_prev_frame,
        return_masks=args.masks,
        min_num_objects=args.coco_min_num_objects,
        overflow_boxes=args.overflow_boxes)
