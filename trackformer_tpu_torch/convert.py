"""Carry the JAX package's weights over to the port.

`jax_params_to_state_dict` turns the JAX param tree (nested mappings of
numpy arrays, as `model.init` returns it after `np.asarray`) into the
port's `state_dict`. The port keeps the original TrackFormer key names, so
the mapping is the inverse of `tools/convert_weights.py:torch_key_for`,
which maps the other way for original checkpoints; no new name table is
needed. Layout changes:

  * Dense kernels (in, out) -> Linear weights (out, in);
  * conv kernels HWIO -> OIHW;
  * the decoder self-attention's q/k/v kernels -> one packed
    `in_proj_weight` (and `in_proj_bias`);
  * FrozenBN buffers, norm scales and biases, `level_embed` and
    `query_embed` copy as they are.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, Mapping

import numpy as np
import torch

_CONVERT_WEIGHTS = (Path(__file__).resolve().parent.parent / "tools"
                    / "convert_weights.py")


def _torch_key_for() -> Callable:
    """`torch_key_for` from tools/convert_weights.py (a numpy-only file
    outside the package, loaded by path)."""
    spec = importlib.util.spec_from_file_location("_convert_weights",
                                                  _CONVERT_WEIGHTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.torch_key_for


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mappings -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params ({"params": {...}}) -> the port's float32 state_dict.
    Raises on a JAX parameter with no original key and on a key that
    would be written twice."""
    torch_key_for = _torch_key_for()
    out: Dict[str, np.ndarray] = {}
    packed: Dict[str, Dict[int, np.ndarray]] = {}
    for path, arr in flatten_tree(params).items():
        mapped = torch_key_for(path)
        if mapped is None:
            raise KeyError(f"no original key for JAX param {path}")
        key, transform = mapped
        a = np.asarray(arr, dtype=np.float32)
        if transform.startswith("qkv_"):
            part = "qkv".index(transform[-1])
            parts = packed.setdefault(key, {})
            if part in parts:
                raise KeyError(f"{key} part {transform} written twice")
            parts[part] = a.T if a.ndim == 2 else a
            continue
        if key in out:
            raise KeyError(f"{key} written twice")
        if transform == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif transform == "linear":
            a = a.T
        elif transform != "copy":
            raise ValueError(f"unknown transform {transform!r} for {path}")
        out[key] = a
    for key, parts in packed.items():
        if sorted(parts) != [0, 1, 2]:
            raise KeyError(f"{key} has q/k/v parts {sorted(parts)}")
        out[key] = np.concatenate([parts[0], parts[1], parts[2]], 0)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
