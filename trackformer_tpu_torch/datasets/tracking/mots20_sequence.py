"""MOTS20 sequences: RLE mask ground truth and MOTS result files.

Counterpart of `trackformer_tpu/datasets/tracking/mots20_sequence.py`:
`load_mots_gt` reads a MOTS text file (`frame id class_id h w rle` lines,
which `mots_line` writes), `MOTS20Sequence` takes its pedestrians' (class 2) boxes from their masks for
the evaluation and writes and reads result files with the challenge's
2000 + id numbering. The RLE codec is the port's (`utils/rle.py`).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import numpy as np

from ...utils import rle
from .mot17_sequence import MOTSequenceBase


def load_mots_gt(gt_file: str) -> Dict[int, list]:
    """A MOTS text file -> {frame: [{"track_id", "class_id", "mask": RLE
    dict}]}."""
    objects_per_frame: Dict[int, list] = {}
    with open(gt_file) as f:
        for line in f:
            fields = line.strip().split(" ")
            if not fields or not fields[0]:
                continue
            objects_per_frame.setdefault(int(fields[0]), []).append({
                "track_id": int(fields[1]),
                "class_id": int(fields[2]),
                "mask": {"size": [int(fields[3]), int(fields[4])],
                         "counts": fields[5]},
            })
    return objects_per_frame


def mots_line(frame: int, track_id: int, class_id: int,
              mask: np.ndarray) -> str:
    """One line of a MOTS text file: 1-based frame, the track id, the class
    (2 pedestrian, 1 car, 10 ignore region), the mask's size and RLE."""
    enc = rle.encode_mask(np.asarray(mask, bool))
    return (f"{frame} {track_id} {class_id} {enc['size'][0]} "
            f"{enc['size'][1]} {enc['counts']}\n")


def _mask_box(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    if not len(ys):
        return None
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


class MOTS20Sequence(MOTSequenceBase):
    data_folder = "MOTS20"

    def get_track_boxes_and_visibility(self):
        boxes = {i: {} for i in range(1, self.seq_length + 1)}
        vis = {i: {} for i in range(1, self.seq_length + 1)}
        gt_file = self.get_gt_file_path()
        if not osp.exists(gt_file):
            return boxes, vis
        for frame, objs in load_mots_gt(gt_file).items():
            for obj in objs:
                if obj["class_id"] != 2:  # MOTS pedestrians
                    continue
                box = _mask_box(rle.decode_mask(obj["mask"]))
                if box is None:
                    continue
                tid = obj["track_id"] % 1000
                boxes[frame][tid] = box
                vis[frame][tid] = 1.0
        return boxes, vis

    def get_gt_file_path(self) -> str:
        return osp.join(self.get_seq_path(), "gt", "gt.txt")

    def write_results(self, results: dict, output_dir: str) -> None:
        """{track id: {frame: {"mask": (H, W) bool, ...}}} -> the sequence's
        MOTS result file, one RLE line per mask (entries without one are
        skipped)."""
        os.makedirs(output_dir, exist_ok=True)
        with open(osp.join(output_dir, self.results_file_name), "w") as f:
            for tid, track in results.items():
                for frame, data in track.items():
                    if "mask" in data:
                        f.write(mots_line(frame + 1, 2000 + tid + 1, 2,
                                          data["mask"]))

    def load_results(self, results_dir):
        """A result file written by `write_results` -> {track id: {frame:
        {"bbox" (the mask's box, zeros for an empty one), "mask",
        "score"}}}; {} without one."""
        results: dict = {}
        if results_dir is None:
            return results
        path = osp.join(results_dir, self.results_file_name)
        if not osp.isfile(path):
            return results
        for frame, objs in load_mots_gt(path).items():
            for obj in objs:
                mask = rle.decode_mask(obj["mask"])
                box = _mask_box(mask)
                results.setdefault(obj["track_id"] - 2000 - 1, {})[
                    frame - 1] = {
                        "bbox": (np.zeros(4, np.float32) if box is None
                                 else box),
                        "mask": mask, "score": 1.0}
        return results
