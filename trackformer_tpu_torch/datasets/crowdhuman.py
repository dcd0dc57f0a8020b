"""CrowdHuman dataset: COCO-style JSON over the CrowdHuman images, with
the synthetic previous frame of the jitter crop (counterpart of
`trackformer_tpu/datasets/crowdhuman.py`)."""
from __future__ import annotations

from pathlib import Path

from .coco import CocoDetection, split_transforms


def build_crowdhuman(image_set: str, args):
    root = Path(args.crowdhuman_path)
    split = args.crowdhuman_train_split
    ann_file = root / "annotations" / f"{split}.json"
    img_folder = root / f"{split}"
    return CocoDetection(
        img_folder, ann_file, *split_transforms(image_set, args),
        prev_frame=args.tracking,
        prev_frame_rnd_augs=args.coco_and_crowdhuman_prev_frame_rnd_augs,
        prev_prev_frame=args.track_prev_prev_frame,
        return_masks=args.masks,
        overflow_boxes=args.overflow_boxes)
