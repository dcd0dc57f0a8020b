"""Dataset facade and fixed-shape batch collation.

Counterpart of `trackformer_tpu/datasets/builder.py`: `build_dataset`,
and `collate_fn`, which pads each batch's images to the smallest of a few
static (H, W) buckets (`tpu.image_buckets`) that holds them, and its
targets to `max_objects` slots, so that a step sees one of a few shapes.
The packs hold the port's `FrameBatch` / `Targets` as CPU tensors;
`pack_to` moves one onto the model's device. `coco_panoptic` and masks
raise `NotImplementedError` (ROADMAP Queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..structures import FrameBatch, Targets


def get_coco_api_from_dataset(dataset):
    """The COCO-style dataset inside concatenations of datasets."""
    for _ in range(10):
        if hasattr(dataset, "anns_by_image"):
            return dataset
        if hasattr(dataset, "datasets"):
            dataset = dataset.datasets[0]
        else:
            break
    raise TypeError(f"no COCO-style dataset inside {type(dataset)}")


def build_dataset(image_set: str, args):
    from .coco import build_coco
    from .crowdhuman import build_crowdhuman
    from .mot import build_mot, build_mot_coco_person, build_mot_crowdhuman

    if args.dataset == "coco":
        return build_coco(image_set, args)
    if args.dataset == "coco_person":
        return build_coco(image_set, args, mode="person_keypoints")
    if args.dataset == "mot":
        return build_mot(image_set, args)
    if args.dataset == "mot_crowdhuman":
        return build_mot_crowdhuman(image_set, args)
    if args.dataset == "mot_coco_person":
        return build_mot_coco_person(image_set, args)
    if args.dataset == "crowdhuman":
        return build_crowdhuman(image_set, args)
    if args.dataset == "coco_panoptic":
        raise NotImplementedError("the panoptic dataset is not ported yet "
                                  "(ROADMAP Queue 1, item 6)")
    raise ValueError(f"dataset {args.dataset!r} not supported")


def pick_bucket(hw_list: Sequence[Tuple[int, int]],
                buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits every (h, w); falls back to the largest."""
    hmax = max(h for h, _ in hw_list)
    wmax = max(w for _, w in hw_list)
    for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
        if bh >= hmax and bw >= wmax:
            return int(bh), int(bw)
    return tuple(max(buckets, key=lambda b: b[0] * b[1]))


def pad_image(img: np.ndarray, bucket: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        raise ValueError(
            f"image ({h}, {w}) exceeds the largest bucket ({bh}, {bw}); "
            "add a larger entry to tpu.image_buckets or lower "
            "img_transform.max_size")
    return np.pad(img, ((0, bh - h), (0, bw - w), (0, 0)))


def pad_targets(targets: List[Dict], max_objects: int) -> Targets:
    """Ragged numpy targets -> `Targets` of `max_objects` slots (objects
    past it dropped), boxes normalized cxcywh as the datasets give them."""
    b, t = len(targets), max_objects
    labels = np.zeros((b, t), np.int32)
    boxes = np.zeros((b, t, 4), np.float32)
    valid = np.zeros((b, t), bool)
    track_ids = np.full((b, t), -1, np.int32)
    area = np.zeros((b, t), np.float32)
    iscrowd = np.zeros((b, t), np.int32)
    orig_size = np.zeros((b, 2), np.int32)
    size = np.zeros((b, 2), np.int32)
    image_id = np.zeros((b,), np.int32)
    for i, tg in enumerate(targets):
        n = min(len(tg["labels"]), t)
        labels[i, :n] = tg["labels"][:n]
        boxes[i, :n] = tg["boxes"][:n]
        valid[i, :n] = True
        track_ids[i, :n] = tg["track_ids"][:n]
        area[i, :n] = tg.get("area", np.zeros(n))[:n]
        iscrowd[i, :n] = tg.get("iscrowd", np.zeros(n))[:n]
        orig_size[i] = tg["orig_size"]
        size[i] = tg["size"]
        image_id[i] = tg["image_id"]
    arrays = dict(labels=labels, boxes=boxes, valid=valid,
                  track_ids=track_ids, orig_size=orig_size, size=size,
                  image_id=image_id, area=area, iscrowd=iscrowd)
    return Targets(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def collate_fn(samples: List[Dict], buckets: Sequence[Tuple[int, int]],
               max_objects: int, with_masks: bool = False) -> Dict:
    """Dataset samples -> a pack: `batch` / `targets` and, for tracking,
    `prev_batch` / `prev_targets`, every frame padded to one bucket."""
    if with_masks:
        raise NotImplementedError("mask targets are not ported yet "
                                  "(ROADMAP Queue 1, item 6)")
    frames = [("image", "target", "batch", "targets"),
              ("prev_image", "prev_target", "prev_batch", "prev_targets")]
    all_hw = [s[k].shape[:2] for s in samples for k, *_ in frames if k in s]
    bucket = pick_bucket(all_hw, buckets)

    pack = {}
    for img_key, tgt_key, batch_name, targets_name in frames:
        if img_key not in samples[0]:
            continue
        imgs = np.stack([pad_image(s[img_key], bucket) for s in samples])
        valid_hw = np.array([s[img_key].shape[:2] for s in samples],
                            np.int32)
        pack[batch_name] = FrameBatch.from_images(torch.from_numpy(imgs),
                                                  torch.from_numpy(valid_hw))
        pack[targets_name] = pad_targets([s[tgt_key] for s in samples],
                                         max_objects)
    return pack


def pack_to(pack: Dict, device) -> Dict:
    """A pack of `collate_fn` with every tensor on `device`."""
    def move(x):
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name).to(device, non_blocking=True)
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    return {k: move(v) for k, v in pack.items()}
