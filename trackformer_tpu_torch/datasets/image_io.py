"""Reading frames from disk as uint8 RGB arrays.

The JAX package opens every frame with `PIL.Image.open(...).convert("RGB")`
inline; the port does the same in one place, with Pillow imported at the
call.
"""
from __future__ import annotations

import numpy as np


def read_frame(path) -> np.ndarray:
    """The image at `path` as uint8 (H, W, 3) RGB."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"reading {path} needs Pillow") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
