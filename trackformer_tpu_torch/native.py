"""ctypes binding of the native host library (`native/trackformer_native.cpp`).

Counterpart of `trackformer_tpu/native.py`: the fused uint8 resize +
normalize + pad of the per-frame input pipeline, and the COCO RLE codec.
The port builds the library itself at first use, from that source with the
flags of `native/Makefile`, into `_build/` beside this package under a name
keyed by the source, the flags and the host CPU (the flags hold
`-march=native`); it never writes into `native/`. A build writes to a
temporary name and renames it, so processes that build at once do not see
each other's half-written files. A failed build raises: there is no other
route.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "trackformer_native.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile's CXXFLAGS, and -shared
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-Wall", "-shared")

_LIB: Optional[ctypes.CDLL] = None


def _cpu_key() -> bytes:
    """What `-march=native` compiles for: the machine and its CPU flags."""
    key = platform.machine().encode()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"model name")):
                    key += line
    except OSError:
        pass
    return key


def so_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + _cpu_key()).hexdigest()
    return BUILD_DIR / f"libtrackformer_native_{key[:16]}.so"


def build() -> Path:
    """The built library's path, compiled first with `g++` (the Makefile's
    default compiler) if it is not there yet."""
    so = so_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native library: building {SOURCE} needs g++"
                           ) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library: g++ failed to build {SOURCE} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.tf_resize_normalize_pad.argtypes = [
        u8p, i64, i64, f32p, i64, i64, i64, i64, f32p, f32p]
    lib.tf_resize_normalize_pad.restype = None
    lib.tf_rle_encode.argtypes = [u8p, i64, i64, ctypes.c_char_p, i64]
    lib.tf_rle_encode.restype = i64
    lib.tf_rle_decode.argtypes = [ctypes.c_char_p, i64, i64, i64, u8p]
    lib.tf_rle_decode.restype = ctypes.c_int
    _LIB = lib
    return lib


def resize_normalize_pad(img_u8: np.ndarray, out_hw: Tuple[int, int],
                         pad_hw: Tuple[int, int], mean: np.ndarray,
                         std: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (pad_h, pad_w, 3): bilinear (PIL's
    triangle filter) resize to `out_hw`, (x / 255 - mean) / std, zeros past
    `out_hw`."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if img_u8.ndim != 3 or img_u8.shape[2] != 3:
        raise ValueError(f"resize_normalize_pad: want (H, W, 3), got "
                         f"{img_u8.shape}")
    if not (0 < out_hw[0] <= pad_hw[0] and 0 < out_hw[1] <= pad_hw[1]):
        raise ValueError(f"resize_normalize_pad: size {out_hw} does not "
                         f"fit the padding {pad_hw}")
    lib = load()
    h, w = img_u8.shape[:2]
    out = np.empty((pad_hw[0], pad_hw[1], 3), np.float32)
    lib.tf_resize_normalize_pad(
        img_u8, h, w, out, out_hw[0], out_hw[1], pad_hw[0], pad_hw[1],
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32))
    return out


def rle_encode(mask: np.ndarray) -> str:
    """(H, W) mask -> COCO compressed RLE counts."""
    lib = load()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    cap = 2 * h * w + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.tf_rle_encode(mask, h, w, buf, cap)
    if n < 0:
        raise ValueError("rle_encode: output buffer too small")
    return buf.raw[:n].decode("ascii")


def rle_decode(counts: str, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE counts -> (h, w) bool mask."""
    lib = load()
    out = np.zeros((h, w), np.uint8)
    s = counts.encode("ascii")
    if lib.tf_rle_decode(s, len(s), h, w, out) != 0:
        raise ValueError("rle_decode: malformed counts")
    return out.astype(bool)
