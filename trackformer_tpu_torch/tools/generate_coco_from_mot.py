"""MOT -> converted-COCO JSON, the annotations that `datasets/mot.py`
trains on.

Counterpart of `tools/generate_coco_from_mot.py`: per image the
frame_id / seq_length / first_frame_image_id fields and a symlink to the
frame in `<data_root>/<split_name>/`; per annotation an int xywh box,
track_id, visibility and ignore (visibility at most 0.25); the frame-range
recipes, among them the cross-validation halves. MOTS (masks) raises
`NotImplementedError` (ROADMAP Queue 1, item 6).

Usage:
  python -m trackformer_tpu_torch.tools.generate_coco_from_mot mot17
  python -m trackformer_tpu_torch.tools.generate_coco_from_mot mot20 \
      --data-root data/MOT20
"""
from __future__ import annotations

import argparse
import configparser
import csv
import json
import os
import os.path as osp
import shutil

VIS_THRESHOLD = 0.25

# MOT15 sequences ship without seqinfo.ini
MOT15_SEQS_INFO = {
    "ETH-Bahnhof": {"img_width": 640, "img_height": 480, "seq_length": 1000},
    "ETH-Sunnyday": {"img_width": 640, "img_height": 480, "seq_length": 354},
    "KITTI-13": {"img_width": 1242, "img_height": 375, "seq_length": 340},
    "KITTI-17": {"img_width": 1224, "img_height": 370, "seq_length": 145},
    "PETS09-S2L1": {"img_width": 768, "img_height": 576, "seq_length": 795},
    "TUD-Campus": {"img_width": 640, "img_height": 480, "seq_length": 71},
    "TUD-Stadtmitte": {"img_width": 640, "img_height": 480,
                       "seq_length": 179},
}


def generate_coco_from_mot(split_name: str, data_root: str,
                           seqs_names=None, root_split: str = "train",
                           frame_range=None, mots: bool = False):
    """Write `<data_root>/annotations/<split_name>.json` over the sequences
    of `<data_root>/<root_split>/` (those in `seqs_names`, if given),
    keeping each sequence's frames in `frame_range` (fractions)."""
    if mots:
        raise NotImplementedError("MOTS (mask) annotations are not ported "
                                  "yet (ROADMAP Queue 1, item 6)")
    frame_range = frame_range or {"start": 0.0, "end": 1.0}
    root_split_path = osp.join(data_root, root_split)
    coco_dir = osp.join(data_root, split_name)
    if osp.isdir(coco_dir):
        shutil.rmtree(coco_dir)
    os.makedirs(coco_dir)

    out = {
        "type": "instances",
        "images": [],
        "categories": [{"supercategory": "person", "name": "person",
                        "id": 1}],
        "annotations": [],
        "frame_range": frame_range,
    }
    os.makedirs(osp.join(data_root, "annotations"), exist_ok=True)
    ann_file = osp.join(data_root, "annotations", f"{split_name}.json")

    seqs = sorted(os.listdir(root_split_path))
    if seqs_names is not None:
        seqs = [s for s in seqs if s in seqs_names]
    out["sequences"] = seqs
    print(split_name, seqs)

    img_id = 0
    name_to_id = {}
    for seq in seqs:
        ini = osp.join(root_split_path, seq, "seqinfo.ini")
        if osp.isfile(ini):
            cfg = configparser.ConfigParser()
            cfg.read(ini)
            width = int(cfg["Sequence"]["imWidth"])
            height = int(cfg["Sequence"]["imHeight"])
            seq_length = int(cfg["Sequence"]["seqLength"])
        else:
            info = MOT15_SEQS_INFO[seq]
            width, height = info["img_width"], info["img_height"]
            seq_length = info["seq_length"]

        img_dir = osp.join(root_split_path, seq, "img1")
        files = sorted(os.listdir(img_dir))
        start = int(frame_range["start"] * seq_length)
        end = int(frame_range["end"] * seq_length)
        files = files[start:end]
        first_frame_image_id = img_id
        for i, fname in enumerate(files):
            out["images"].append({
                "file_name": f"{seq}_{fname}", "height": height,
                "width": width, "id": img_id, "frame_id": i,
                "seq_length": len(files),
                "first_frame_image_id": first_frame_image_id,
            })
            name_to_id[f"{seq}_{fname}"] = img_id
            link = osp.join(coco_dir, f"{seq}_{fname}")
            if not osp.lexists(link):
                os.symlink(osp.abspath(osp.join(img_dir, fname)), link)
            img_id += 1

    ann_id = 0
    for seq in seqs:
        gt_file = osp.join(root_split_path, seq, "gt", "gt.txt")
        if not osp.isfile(gt_file):
            continue
        is_mot15 = seq in MOT15_SEQS_INFO
        with open(gt_file) as f:
            for row in csv.reader(f):
                if int(row[6]) != 1 or (not is_mot15 and int(row[7]) != 1):
                    continue
                bbox = [int(float(c)) for c in row[2:6]]
                vis = float(row[8])
                # frames outside the range were not linked: skipped
                image_id = name_to_id.get(f"{seq}_{int(row[0]):06d}.jpg")
                if image_id is None:
                    continue
                out["annotations"].append({
                    "id": ann_id, "bbox": bbox, "image_id": image_id,
                    "segmentation": [],
                    "ignore": int(vis <= VIS_THRESHOLD),
                    "visibility": vis, "area": bbox[2] * bbox[3],
                    "iscrowd": 0, "seq": seq, "category_id": 1,
                    "track_id": int(row[1]),
                })
                ann_id += 1

    with open(ann_file, "w") as f:
        json.dump(out, f)
    print(f"wrote {ann_file}: {len(out['images'])} images, "
          f"{len(out['annotations'])} annotations")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["mot17", "mot20", "mots20"])
    ap.add_argument("--data-root", default=None)
    args = ap.parse_args(argv)

    root = args.data_root or f"data/{args.dataset.upper()}"
    mots = args.dataset == "mots20"
    name = args.dataset

    generate_coco_from_mot(f"{name}_train_coco", root, mots=mots)
    # the cross-validation halves (the configs validate on 0.5 -> 1.0)
    generate_coco_from_mot(
        f"{name}_train_cross_val_frame_0_0_to_0_5_coco", root, mots=mots,
        frame_range={"start": 0.0, "end": 0.5})
    generate_coco_from_mot(
        f"{name}_train_cross_val_frame_0_5_to_1_0_coco", root, mots=mots,
        frame_range={"start": 0.5, "end": 1.0})


if __name__ == "__main__":
    main()
