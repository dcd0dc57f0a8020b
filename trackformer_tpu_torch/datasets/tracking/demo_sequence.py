"""Demo sequence: a directory of images, or a video file.

Counterpart of `trackformer_tpu/datasets/tracking/demo_sequence.py`.
Images are read by `image_io.read_frame`; a video is decoded with OpenCV,
imported at that call, as in the JAX package.
"""
from __future__ import annotations

import os
import os.path as osp
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..image_io import read_frame
from .mot17_sequence import eval_resize, frame_blob, write_mot_results

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp"}
VID_EXTS = {".mp4", ".avi", ".mov", ".mkv"}


class DemoSequence:
    data_folder = "DEMO"

    def __init__(self, root_dir: str = "data", img_transform=None):
        self._data_dir = Path(root_dir)
        if not self._data_dir.exists():
            raise FileNotFoundError(f"data_root_dir not found: {root_dir}")
        self._resize = eval_resize(img_transform)
        self._frames: List[np.ndarray] = []
        self._paths: List[str] = []

        files = sorted(self._data_dir.iterdir()) \
            if self._data_dir.is_dir() else [self._data_dir]
        video = [f for f in files if f.suffix.lower() in VID_EXTS]
        images = [f for f in files if f.suffix.lower() in IMG_EXTS]
        if images:
            self._paths = [str(p) for p in images]
        elif video:
            import cv2
            cap = cv2.VideoCapture(str(video[0]))
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                self._frames.append(frame[:, :, ::-1].copy())  # BGR -> RGB
            cap.release()
        else:
            raise FileNotFoundError(
                f"no images or video in {self._data_dir}")

    def __str__(self) -> str:
        return self._data_dir.name

    def __len__(self) -> int:
        return len(self._paths) or len(self._frames)

    @property
    def no_gt(self) -> bool:
        return True

    def __getitem__(self, idx: int) -> dict:
        if self._paths:
            img_u8 = read_frame(self._paths[idx])
            path = self._paths[idx]
        else:
            img_u8 = self._frames[idx]
            path = f"{self}_{idx:06d}.jpg"
        return {
            **frame_blob(img_u8, self._resize),
            "dets": np.zeros((0, 4), np.float32),
            "img_path": path,
            "gt": {},
            "vis": {},
        }

    def write_results(self, results: dict, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        write_mot_results(results, osp.join(output_dir, f"{self}.txt"))

    def load_results(self, results_dir: Optional[str]) -> dict:
        return {}
