"""Joint image + annotation transforms (host side, numpy and Pillow).

Counterpart of `trackformer_tpu/datasets/transforms.py`: crop with the
overflow-boxes mode, hflip, the aspect-preserving resize with a cap on the
longer side, the random and centre crops, RandomHorizontalFlip /
RandomResize / RandomPad / RandomSelect, RandomErasing, Normalize to
normalized cxcywh, Compose, and `make_coco_transforms`, the training and
val pipelines.

Every random transform draws from an explicit `numpy.random.Generator`,
as in the JAX package: the datasets replay a seed so that a frame's
augmentation matches its previous frame's. Images are numpy float32 HWC
in [0, 1] (or uint8); the resize goes through Pillow on uint8, as the JAX
package's does, so that the pipelines give the same arrays bit for bit.
The serving path preprocesses its frames natively instead
(`tracking/mot17_sequence.py:preprocess_frame`). Masks raise
`NotImplementedError` (ROADMAP Queue 1, item 6).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _box_area(b):
    return np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)


def _no_masks(target: Optional[Dict]) -> None:
    if target is not None and target.get("masks") is not None \
            and len(target["masks"]):
        raise NotImplementedError("transforming masks is not ported yet "
                                  "(ROADMAP Queue 1, item 6)")


def crop(img: np.ndarray, target: Dict, region: Tuple[int, int, int, int],
         overflow_boxes: bool = False):
    """region = (top, left, height, width); boxes xyxy absolute."""
    _no_masks(target)
    i, j, h, w = region
    img = img[i:i + h, j:j + w]
    target = dict(target)
    target["size"] = np.array([h, w], np.int64)

    if "boxes" in target and len(target["boxes"]):
        boxes = target["boxes"] - np.array([j, i, j, i], np.float32)
        if overflow_boxes:
            # keep boxes that extend past the crop; drop fully-outside ones
            keep = ((boxes[:, 0] < w) & (boxes[:, 2] > 0)
                    & (boxes[:, 1] < h) & (boxes[:, 3] > 0))
        else:
            boxes = np.stack([
                boxes[:, 0].clip(0, w), boxes[:, 1].clip(0, h),
                boxes[:, 2].clip(0, w), boxes[:, 3].clip(0, h)], axis=1)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        target["boxes"] = boxes.astype(np.float32)
        target["area"] = _box_area(boxes)
        _filter(target, keep)
    return img, target


def _filter(target: Dict, keep: np.ndarray):
    for key in ("boxes", "labels", "area", "iscrowd", "track_ids", "ignore"):
        if key in target and target[key] is not None and len(target[key]):
            target[key] = target[key][keep]


def hflip(img: np.ndarray, target: Dict):
    _no_masks(target)
    img = img[:, ::-1].copy()
    target = dict(target)
    h, w = img.shape[:2]
    if "boxes" in target and len(target["boxes"]):
        b = target["boxes"]
        target["boxes"] = np.stack(
            [w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], axis=1)
    return img, target


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


def resize(img: np.ndarray, target: Optional[Dict], size,
           max_size: Optional[int] = None):
    """uint8, or float in [0, 1] (taken to uint8 as the JAX package does),
    (H, W, 3) -> float32 in [0, 1] at the target size, by Pillow's bilinear
    filter; boxes (absolute xyxy), area and size of `target` follow."""
    from PIL import Image

    _no_masks(target)
    h, w = img.shape[:2]
    if isinstance(size, (list, tuple)):
        nh, nw = size
    else:
        nh, nw = get_size_with_aspect_ratio((h, w), size, max_size)
    pil = Image.fromarray(img if img.dtype == np.uint8
                          else (img * 255).astype(np.uint8))
    img_r = np.asarray(pil.resize((nw, nh), Image.BILINEAR),
                       np.float32) / 255.0
    if target is None:
        return img_r, None
    target = dict(target)
    rw, rh = nw / w, nh / h
    if "boxes" in target and len(target["boxes"]):
        target["boxes"] = target["boxes"] * np.array([rw, rh, rw, rh],
                                                     np.float32)
        target["area"] = target.get("area", _box_area(target["boxes"])) \
            * (rw * rh)
    target["size"] = np.array([nh, nw], np.int64)
    return img_r, target


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, img, target, rng):
        for t in self.transforms:
            img, target = t(img, target, rng)
        return img, target


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, target, rng):
        if rng.random() < self.p:
            return hflip(img, target)
        return img, target


class RandomResize:
    def __init__(self, sizes, max_size=None):
        self.sizes = list(sizes)
        self.max_size = max_size

    def __call__(self, img, target, rng):
        size = self.sizes[rng.integers(len(self.sizes))]
        return resize(img, target, size, self.max_size)


class FixedResize:
    def __init__(self, size, max_size=None):
        self.size = size
        self.max_size = max_size

    def __call__(self, img, target, rng=None):
        return resize(img, target, self.size, self.max_size)


class RandomSizeCrop:
    def __init__(self, min_size: int, max_size: int,
                 overflow_boxes: bool = False):
        self.min_size = min_size
        self.max_size = max_size
        self.overflow_boxes = overflow_boxes

    def __call__(self, img, target, rng):
        h, w = img.shape[:2]
        cw = int(rng.integers(self.min_size, min(w, self.max_size) + 1)) \
            if min(w, self.max_size) >= self.min_size else w
        ch = int(rng.integers(self.min_size, min(h, self.max_size) + 1)) \
            if min(h, self.max_size) >= self.min_size else h
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        return crop(img, target, (top, left, ch, cw), self.overflow_boxes)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img, target, rng=None):
        h, w = img.shape[:2]
        ch, cw = self.size
        top = (h - ch) // 2
        left = (w - cw) // 2
        return crop(img, target, (top, left, ch, cw))


class RandomPad:
    def __init__(self, max_pad: int):
        self.max_pad = max_pad

    def __call__(self, img, target, rng):
        _no_masks(target)
        pr = int(rng.integers(0, self.max_pad + 1))
        pb = int(rng.integers(0, self.max_pad + 1))
        img = np.pad(img, ((0, pb), (0, pr), (0, 0)))
        target = dict(target)
        target["size"] = np.array(img.shape[:2], np.int64)
        return img, target


class RandomSelect:
    """Apply transform a with prob p else b."""

    def __init__(self, a, b, p: float = 0.5):
        self.a, self.b, self.p = a, b, p

    def __call__(self, img, target, rng):
        if rng.random() < self.p:
            return self.a(img, target, rng)
        return self.b(img, target, rng)


class RandomErasing:
    """Erase a random rectangle with uniform noise; the boxes stay."""

    def __init__(self, p=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
        self.p, self.scale, self.ratio = p, scale, ratio

    def __call__(self, img, target, rng):
        if rng.random() >= self.p:
            return img, target
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            ea = rng.uniform(*self.scale) * area
            ar = np.exp(rng.uniform(np.log(self.ratio[0]),
                                    np.log(self.ratio[1])))
            eh = int(round(np.sqrt(ea * ar)))
            ew = int(round(np.sqrt(ea / ar)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                img = img.copy()
                img[top:top + eh, left:left + ew] = rng.random(
                    (eh, ew, img.shape[2]), dtype=np.float32)
                break
        return img, target


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


def make_coco_transforms(image_set: str, img_transform=None,
                         overflow_boxes: bool = False,
                         no_crop: bool = False):
    """The training and val pipelines, Normalize last."""
    max_size = 1333
    val_width = 800
    if img_transform is not None:
        max_size = int(getattr(img_transform, "max_size", max_size))
        val_width = int(getattr(img_transform, "val_width", val_width))

    scale = max_size / 1333.0
    scales = [int(s * scale) for s in
              (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)]
    random_resizes = [int(s * scale) for s in (400, 500, 600)]
    random_size_crop = (int(384 * scale), int(600 * scale))

    normalize = Normalize()
    if image_set == "train":
        ts = [RandomHorizontalFlip()]
        if no_crop:
            ts.append(RandomResize(scales, max_size=max_size))
        else:
            ts.append(RandomSelect(
                RandomResize(scales, max_size=max_size),
                Compose([
                    RandomResize(random_resizes),
                    RandomSizeCrop(*random_size_crop,
                                   overflow_boxes=overflow_boxes),
                    RandomResize(scales, max_size=max_size),
                ])))
        ts.append(normalize)
        return Compose(ts)
    if image_set == "val":
        return Compose([FixedResize(val_width, max_size=max_size), normalize])
    raise ValueError(f"unknown image_set {image_set!r}")
