"""Eval-time image transforms (host side, numpy and the native library).

Counterpart of the eval part of `trackformer_tpu/datasets/transforms.py`:
the ImageNet statistics, the aspect-preserving target size with a cap on
the longer side, `FixedResize` and `Normalize`. The resize is the native
library's bilinear (PIL's triangle filter) kept in float32, where the JAX
package's PIL route rounds the resized image to uint8 (up to one uint8
level apart). The training transforms are not ported yet (ROADMAP Queue 1,
item 8).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .. import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_ZERO = np.zeros(3, np.float32)
_ONE = np.ones(3, np.float32)


def get_size_with_aspect_ratio(hw: Tuple[int, int], size: int,
                               max_size: Optional[int] = None):
    h, w = hw
    if max_size is not None:
        min_wh, max_wh = float(min(w, h)), float(max(w, h))
        if max_wh / min_wh * size > max_size:
            size = int(round(max_size * min_wh / max_wh))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def _box_area(b):
    return np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)


def resize(img: np.ndarray, target: Optional[Dict], size,
           max_size: Optional[int] = None):
    """uint8 (or float in [0, 1], taken to uint8 as the JAX package does)
    (H, W, 3) -> float32 in [0, 1] at the target size; boxes (absolute
    xyxy), area and size of `target` follow."""
    h, w = img.shape[:2]
    if isinstance(size, (list, tuple)):
        nh, nw = size
    else:
        nh, nw = get_size_with_aspect_ratio((h, w), size, max_size)
    img_u8 = img if img.dtype == np.uint8 else (img * 255).astype(np.uint8)
    img_r = native.resize_normalize_pad(img_u8, (nh, nw), (nh, nw), _ZERO,
                                        _ONE)
    if target is None:
        return img_r, None
    if target.get("masks") is not None and len(target["masks"]):
        raise NotImplementedError("resizing masks is not ported yet "
                                  "(ROADMAP Queue 1, item 6)")
    target = dict(target)
    rw, rh = nw / w, nh / h
    if "boxes" in target and len(target["boxes"]):
        target["boxes"] = target["boxes"] * np.array([rw, rh, rw, rh],
                                                     np.float32)
        target["area"] = target.get("area", _box_area(target["boxes"])) \
            * (rw * rh)
    target["size"] = np.array([nh, nw], np.int64)
    return img_r, target


class FixedResize:
    def __init__(self, size, max_size=None):
        self.size = size
        self.max_size = max_size

    def __call__(self, img, target, rng=None):
        return resize(img, target, self.size, self.max_size)


class Normalize:
    """Normalize the image; boxes -> normalized cxcywh."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean, self.std = mean, std

    def __call__(self, img, target, rng=None):
        img = (img - self.mean) / self.std
        if target is None:
            return img.astype(np.float32), None
        target = dict(target)
        h, w = img.shape[:2]
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"].astype(np.float32)
            cx = (b[:, 0] + b[:, 2]) / 2 / w
            cy = (b[:, 1] + b[:, 3]) / 2 / h
            bw = (b[:, 2] - b[:, 0]) / w
            bh = (b[:, 3] - b[:, 1]) / h
            target["boxes"] = np.stack([cx, cy, bw, bh], axis=1)
        return img.astype(np.float32), target
