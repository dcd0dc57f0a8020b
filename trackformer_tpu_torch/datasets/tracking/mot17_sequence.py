"""MOT17 inference sequences: per-frame blobs and MOTChallenge result I/O.

Counterpart of `trackformer_tpu/datasets/tracking/mot17_sequence.py`: the
per-frame blob, the public `det.txt` with its 1-based -> 0-based
conversion, `gt.txt` with its class, considered-flag and visibility
filters, `seqinfo.ini`, and the byte format of MOTChallenge result files
(1-based frame and id, xywh with the +1 / -1 width convention).

A blob's `FrameBatch` holds CPU tensors, the frame padded to multiples of
64 so that a sequence has one shape; `Tracker.step` moves it to the
model's device. Frames are read by `image_io.read_frame` and preprocessed
by the native library alone (the JAX package falls back to PIL when its
library is not built, which rounds the resized frame to uint8).
"""
from __future__ import annotations

import configparser
import csv
import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import native
from ...structures import FrameBatch
from .. import transforms as T
from ..image_io import read_frame


def round_up(x: int, m: int = 64) -> int:
    return ((x + m - 1) // m) * m


def preprocess_frame(img_u8: np.ndarray, resize: "T.FixedResize"):
    """uint8 HWC frame -> (float32 frame padded to multiples of 64, valid
    (h, w)), by the native fused resize + normalize + pad."""
    oh, ow = img_u8.shape[:2]
    th, tw = T.get_size_with_aspect_ratio((oh, ow), resize.size,
                                          resize.max_size)
    out = native.resize_normalize_pad(img_u8, (th, tw),
                                      (round_up(th), round_up(tw)),
                                      T.IMAGENET_MEAN, T.IMAGENET_STD)
    return out, (th, tw)


def frame_blob(img_u8: np.ndarray, resize: "T.FixedResize") -> dict:
    """The model-input part of a blob: the preprocessed frame as a
    `FrameBatch` of CPU tensors, its original and its valid size."""
    oh, ow = img_u8.shape[:2]
    padded, (h, w) = preprocess_frame(img_u8, resize)
    bh, bw = padded.shape[:2]
    mask = (np.arange(bh)[:, None] >= h) | (np.arange(bw)[None, :] >= w)
    return {
        "batch": FrameBatch(images=torch.from_numpy(padded[None]),
                            mask=torch.from_numpy(mask[None])),
        "orig_size": np.array([[oh, ow]], np.int32),
        "size": np.array([[h, w]], np.int32),
    }


def eval_resize(img_transform) -> "T.FixedResize":
    """The eval transform of a train config's `img_transform`."""
    val_width = int(getattr(img_transform, "val_width", 800) or 800)
    max_size = int(getattr(img_transform, "max_size", 1333) or 1333)
    return T.FixedResize(val_width, max_size=max_size)


def write_mot_results(results: Dict[int, Dict[int, dict]],
                      path: str) -> None:
    """{track id: {frame: {"bbox": xyxy}}} -> a MOTChallenge result file."""
    with open(path, "w") as f:
        writer = csv.writer(f)
        for tid, track in results.items():
            for frame, data in track.items():
                x1, y1, x2, y2 = data["bbox"][:4]
                writer.writerow([frame + 1, tid + 1, x1 + 1, y1 + 1,
                                 x2 - x1 + 1, y2 - y1 + 1, -1, -1, -1, -1])


class MOTSequenceBase:
    """One MOTChallenge sequence, iterated frame by frame."""

    data_folder = "MOT17"

    def __init__(self, root_dir: str = "data", seq_name: Optional[str] = None,
                 dets: Optional[str] = None, vis_threshold: float = 0.0,
                 img_transform=None):
        self._seq_name = seq_name
        self._dets = dets
        self._vis_threshold = vis_threshold
        self._data_dir = osp.join(root_dir, self.data_folder)
        self._resize = eval_resize(img_transform)

        self.data: List[dict] = []
        self.no_gt = True
        if seq_name is not None:
            train = set(os.listdir(osp.join(self._data_dir, "train"))) \
                if osp.isdir(osp.join(self._data_dir, "train")) else set()
            test = set(os.listdir(osp.join(self._data_dir, "test"))) \
                if osp.isdir(osp.join(self._data_dir, "test")) else set()
            full = str(self)
            if full not in train and full not in test:
                raise FileNotFoundError(f"Image set does not exist: {full}")
            self._train_folders, self._test_folders = train, test
            self.data = self._sequence()
            self.no_gt = not osp.exists(self.get_gt_file_path())

    def __str__(self):
        if self._dets is None:
            return str(self._seq_name)
        return f"{self._seq_name}-{self._dets}"

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> dict:
        d = self.data[idx]
        return {
            **frame_blob(read_frame(d["im_path"]), self._resize),
            "dets": np.asarray([det[:4] for det in d["dets"]],
                               np.float32).reshape(-1, 4),
            "img_path": d["im_path"],
            "gt": d["gt"],
            "vis": d["vis"],
        }

    # --- sequence layout -------------------------------------------------
    def get_seq_path(self) -> str:
        full = str(self)
        sub = "train" if full in self._train_folders else "test"
        return osp.join(self._data_dir, sub, full)

    @property
    def config(self) -> configparser.ConfigParser:
        cfg = configparser.ConfigParser()
        cfg.read(osp.join(self.get_seq_path(), "seqinfo.ini"))
        return cfg

    @property
    def seq_length(self) -> int:
        return int(self.config["Sequence"]["seqLength"])

    def get_gt_file_path(self) -> str:
        return osp.join(self.get_seq_path(), "gt", "gt.txt")

    def get_det_file_path(self) -> str:
        if self._dets is None:
            return ""
        return osp.join(self.get_seq_path(), "det", "det.txt")

    def _sequence(self) -> List[dict]:
        dets = {i: [] for i in range(1, self.seq_length + 1)}
        det_file = self.get_det_file_path()
        if det_file and osp.exists(det_file):
            with open(det_file) as f:
                for row in csv.reader(f):
                    x1 = float(row[2]) - 1
                    y1 = float(row[3]) - 1
                    x2 = x1 + float(row[4]) - 1
                    y2 = y1 + float(row[5]) - 1
                    dets[int(float(row[0]))].append(
                        np.array([x1, y1, x2, y2, float(row[6])],
                                 np.float32))
        boxes, vis = self.get_track_boxes_and_visibility()
        img_dir = osp.join(self.get_seq_path(),
                           self.config["Sequence"]["imDir"])
        ext = self.config["Sequence"].get("imExt", ".jpg")
        return [
            {"gt": boxes[i], "vis": vis[i], "dets": dets[i],
             "im_path": osp.join(img_dir, f"{i:06d}{ext}")}
            for i in range(1, self.seq_length + 1)]

    def get_track_boxes_and_visibility(self) -> Tuple[dict, dict]:
        boxes = {i: {} for i in range(1, self.seq_length + 1)}
        vis = {i: {} for i in range(1, self.seq_length + 1)}
        gt_file = self.get_gt_file_path()
        if not osp.exists(gt_file):
            return boxes, vis
        with open(gt_file) as f:
            for row in csv.reader(f):
                # pedestrian class, considered flag, visibility threshold
                if int(row[6]) == 1 and int(row[7]) == 1 and \
                        float(row[8]) >= self._vis_threshold:
                    x1 = int(row[2]) - 1
                    y1 = int(row[3]) - 1
                    x2 = x1 + int(row[4]) - 1
                    y2 = y1 + int(row[5]) - 1
                    frame, tid = int(row[0]), int(row[1])
                    boxes[frame][tid] = np.array([x1, y1, x2, y2], np.float32)
                    vis[frame][tid] = float(row[8])
        return boxes, vis

    # --- results I/O ------------------------------------------------------
    @property
    def results_file_name(self) -> str:
        assert self._seq_name is not None
        if self._dets is None:
            return f"{self._seq_name}.txt"
        return f"{self}.txt"

    def write_results(self, results: Dict[int, Dict[int, dict]],
                      output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        write_mot_results(results, osp.join(output_dir,
                                            self.results_file_name))

    def load_results(self, results_dir: Optional[str]) -> dict:
        results: Dict[int, Dict[int, dict]] = {}
        if results_dir is None:
            return results
        path = osp.join(results_dir, self.results_file_name)
        if not osp.isfile(path):
            return results
        with open(path) as f:
            for row in csv.reader(f):
                frame, tid = int(row[0]) - 1, int(row[1]) - 1
                x1 = float(row[2]) - 1
                y1 = float(row[3]) - 1
                x2 = float(row[4]) - 1 + x1
                y2 = float(row[5]) - 1 + y1
                results.setdefault(tid, {})[frame] = {
                    "bbox": [x1, y1, x2, y2], "score": 1.0}
        return results


class MOT17Sequence(MOTSequenceBase):
    data_folder = "MOT17"
