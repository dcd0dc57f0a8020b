"""CrowdHuman `.odgt` -> converted-COCO JSON, what `datasets/crowdhuman.py`
trains on.

Counterpart of `tools/generate_coco_from_crowdhuman.py`: one image a line
of `annotation_<split>.odgt`, a synthetic sequence of one frame each
(`frame_id` 0, `seq_length` 1), and one annotation per `person` full box
(`fbox`, int xywh) with the odgt's `extra.ignore` flag and its own track
id. Writes `<data_root>/annotations/<split>.json` (`train_val.json` for the
merged split `trainval`).

Usage:
  python -m trackformer_tpu_torch.tools.generate_coco_from_crowdhuman \\
      --data-root data/CrowdHuman --splits train val
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp


def generate(split: str, data_root: str) -> str:
    """Convert one split -> the path of the JSON written."""
    out = {"type": "instances", "images": [], "annotations": [],
           "categories": [{"supercategory": "person", "name": "person",
                           "id": 1}]}
    img_id = ann_id = 0
    with open(osp.join(data_root, f"annotation_{split}.odgt")) as f:
        for line in f:
            rec = json.loads(line)
            out["images"].append({
                "file_name": f"{rec['ID']}.jpg", "id": img_id,
                "frame_id": 0, "seq_length": 1,
                "first_frame_image_id": img_id})
            for gt in rec.get("gtboxes", []):
                if gt.get("tag") != "person":
                    continue
                x, y, w, h = (int(v) for v in gt["fbox"])
                out["annotations"].append({
                    "id": ann_id, "image_id": img_id, "category_id": 1,
                    "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                    "ignore": int(gt.get("extra", {}).get("ignore", 0)),
                    "visibility": 1.0, "track_id": ann_id})
                ann_id += 1
            img_id += 1
    os.makedirs(osp.join(data_root, "annotations"), exist_ok=True)
    name = "train_val" if split == "trainval" else split
    path = osp.join(data_root, "annotations", f"{name}.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"wrote {path}: {img_id} images, {ann_id} annotations")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default="data/CrowdHuman")
    ap.add_argument("--splits", nargs="+", default=["train", "val"])
    args = ap.parse_args(argv)
    return [generate(split, args.data_root) for split in args.splits]


if __name__ == "__main__":
    main()
