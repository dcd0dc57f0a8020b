"""MOT training dataset: real adjacent frames from converted COCO JSONs.

Counterpart of `trackformer_tpu/datasets/mot.py`: a real previous frame
drawn within `prev_frame_range`, the per-sample weight 1 / seq_length,
`write_result_files`, `WeightedConcatDataset` and the mot /
mot + crowdhuman / mot + coco_person builders.

The images of a split live in `<root>/<split>/`, where
`tools/generate_coco_from_mot.py` links them (`<seq>_<frame>.jpg`); where
that folder does not exist they are read from `<root>/train/`, where the
JAX package reads them (ROADMAP Queue 3).
"""
from __future__ import annotations

import copy
import csv
import os
from pathlib import Path
from typing import Dict, List

import numpy as np

from .coco import CocoDetection, split_transforms


class MOT(CocoDetection):
    def __init__(self, *args, prev_frame_range: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self._prev_frame_range = prev_frame_range

    def seq_position(self, idx: int):
        info = self.frames_info[self.ids[idx]]
        return info["frame_id"], info["seq_length"], \
            info["first_frame_image_id"]

    def __getitem__(self, idx: int):
        seed = int(np.random.randint(0, 2**31 - 1))
        img, target = self._getitem_from_id(idx, seed, random_jitter=False)
        sample = {"image": img, "target": target}

        if self._prev_frame:
            frame_id, seq_len, first_id = self.seq_position(idx)
            rng = np.random.default_rng(seed + 1)
            lo = max(0, frame_id - self._prev_frame_range)
            hi = min(seq_len - 1, frame_id + self._prev_frame_range)
            prev_frame_id = int(rng.integers(lo, hi + 1))
            prev_idx = self.ids.index(first_id + prev_frame_id)

            prev_img, prev_target = self._getitem_from_id(prev_idx, seed)
            sample["prev_image"] = prev_img
            sample["prev_target"] = prev_target
        return sample

    def write_result_files(self, results, output_dir: str,
                           score_thresh: float = 0.7) -> List[str]:
        """Per-sequence detection files (MOT17Det `det.txt` lines) from
        `results`, {image_id: {"boxes" xyxy, "scores"}} as `make_results`
        gives them: one `<seq>.txt` per sequence with lines `<frame>, -1,
        <bb_left>, <bb_top>, <bb_w>, <bb_h>, <conf>, -1, -1, -1` for each
        detection scored above `score_thresh`. Sequence names may hold
        underscores. Returns the files written."""
        files: Dict[str, list] = {}
        for image_id, res in results.items():
            stem = os.path.splitext(self.images[image_id]["file_name"])[0]
            if "/" in stem:  # <seq>/img1/<frame>.jpg source layout
                seq_name, frame = stem.split("/")[0], stem.split("/")[-1]
            else:  # converter layout <seq>_<frame>.jpg
                seq_name, frame = stem.rsplit("_", 1)
            rows = files.setdefault(
                os.path.join(output_dir, f"{seq_name}.txt"), [])
            boxes = np.asarray(res["boxes"], np.float64).reshape(-1, 4)
            scores = np.asarray(res["scores"], np.float64).reshape(-1)
            for box, score in zip(boxes, scores):
                if score <= score_thresh:
                    continue
                x1, y1, x2, y2 = box
                rows.append([int(frame), -1, x1, y1, x2 - x1, y2 - y1,
                             float(score), -1, -1, -1])

        os.makedirs(output_dir, exist_ok=True)
        for path, rows in files.items():
            with open(path, "w", newline="") as f:
                writer = csv.writer(f, delimiter=",")
                for row in rows:
                    writer.writerow(row)
        return sorted(files)


class WeightedConcatDataset:
    """Datasets end to end, each sampled by its own per-sample weights
    normalized to sum to one."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cum, idx, side="right"))
        base = 0 if d == 0 else int(self.cum[d - 1])
        return self.datasets[d][idx - base]

    @property
    def sample_weights(self) -> np.ndarray:
        ws = []
        for d in self.datasets:
            w = getattr(d, "sample_weights", np.ones(len(d)))
            ws.append(w / w.sum() if w.sum() else w)
        return np.concatenate(ws)


def _mot_dataset(split: str, root: str, args, image_set: str,
                 prev_frame_range: int):
    root = Path(root)
    ann_file = root / "annotations" / f"{split}.json"
    img_folder = root / split if (root / split).is_dir() else root / "train"
    return MOT(img_folder, ann_file, *split_transforms(image_set, args),
               prev_frame_range=prev_frame_range,
               prev_frame=args.tracking,
               prev_frame_rnd_augs=(args.track_prev_frame_rnd_augs
                                    if image_set == "train" else 0.0),
               prev_prev_frame=args.track_prev_prev_frame,
               return_masks=args.masks,
               overflow_boxes=args.overflow_boxes)


def build_mot(image_set: str, args):
    split = args.train_split if image_set == "train" else args.val_split
    root = args.mot_path_train if image_set == "train" else args.mot_path_val
    rng = args.track_prev_frame_range if image_set == "train" else 1
    return _mot_dataset(split, root, args, image_set, rng)


def build_mot_crowdhuman(image_set: str, args):
    from .crowdhuman import build_crowdhuman
    datasets = []
    if (args.train_split if image_set == "train" else args.val_split):
        datasets.append(build_mot(image_set, args))
    if image_set == "train" and args.crowdhuman_train_split:
        datasets.append(build_crowdhuman("train", args))
    if len(datasets) == 1:
        return datasets[0]
    return WeightedConcatDataset(datasets)


def build_mot_coco_person(image_set: str, args):
    from .coco import build_coco
    datasets = []
    if (args.train_split if image_set == "train" else args.val_split):
        datasets.append(build_mot(image_set, args))
    if image_set == "train" and args.coco_person_train_split:
        pa = copy.copy(args)
        pa.train_split = args.coco_person_train_split
        datasets.append(build_coco("train", pa, mode="person_keypoints"))
    if len(datasets) == 1:
        return datasets[0]
    return WeightedConcatDataset(datasets)
