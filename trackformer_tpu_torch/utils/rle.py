"""COCO-style mask utilities without pycocotools.

Counterpart of `trackformer_tpu/utils/rle.py`, kept as it is there (pure
numpy and Pillow) so that both packages give the same strings and masks:
the COCO compressed RLE string format (column-major runs, LEB128-style
varint with sign-zigzag deltas) used by CrowdHuman / MOTS annotations and
MOTS result files, and polygon rasterization through Pillow. The native
library's codec (`native.rle_encode` / `rle_decode`) is the serving path's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """Binary (H, W) mask -> uncompressed RLE counts (column-major)."""
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return counts


def rle_counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F").astype(bool)


def encode_rle_string(counts: Sequence[int]) -> str:
    """COCO compressed RLE: zigzag delta (from 3rd element) + 6-bit varint."""
    s = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or
                        (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def decode_rle_string(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return counts


def encode_mask(mask: np.ndarray) -> Dict:
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": encode_rle_string(mask_to_rle_counts(mask))}


def decode_mask(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decode_rle_string(counts)
    return rle_counts_to_mask(counts, h, w)


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int,
                     w: int) -> np.ndarray:
    """COCO polygon segmentation -> binary mask (union of polygons)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, bool)


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation variant -> (H, W) bool mask."""
    if isinstance(segm, dict):
        return decode_mask(segm)
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    raise TypeError(f"unsupported segmentation type {type(segm)}")


def mask_area(rle_or_mask) -> int:
    if isinstance(rle_or_mask, dict):
        counts = rle_or_mask["counts"]
        if isinstance(counts, (str, bytes)):
            counts = decode_rle_string(counts)
        return int(sum(counts[1::2]))
    return int(np.sum(rle_or_mask))


def rle_iou(a: Dict, b: Dict) -> float:
    """IoU of two RLE masks (decoded; MOTS-scale masks are small enough)."""
    ma, mb = decode_mask(a), decode_mask(b)
    inter = np.logical_and(ma, mb).sum()
    union = np.logical_or(ma, mb).sum()
    return float(inter) / float(union) if union else 0.0
