"""Carry the JAX package's weights over to the port.

`jax_params_to_state_dict` turns the JAX param tree (nested mappings of
numpy arrays, as `model.init` returns it after `np.asarray`) into the
port's `state_dict`. The port keeps the original TrackFormer key names;
`torch_key_for` maps each JAX param path to its key. It is this package's
own copy of the parts of the JAX package's converter
(`tools/convert_weights.py:torch_key_for`) that the ported models use,
extended with the TPU-fast mode's params, which have no original key:

  * `encoder/layer_i/self_attn/{q,k,v}_proj` pack into
    `transformer.encoder.layers.{i}.self_attn.in_proj_{weight,bias}`, as
    the decoder's self-attention does; `out_proj`, `norm1/2` and
    `linear1/2` map as in the deformable encoder;
  * `encoder/fuse_i/{up,down,norm}_j` ->
    `transformer.encoder.fuse.{i}.{up,down,norm}.{j}.{weight,bias}`;
  * `frame_embed` -> `transformer.frame_embed`.

The map is linear (transposes and the q/k/v packing), so the same function
carries a JAX gradient tree, or the params after an optimizer update, to
the port's names: the training tests compare gradients and post-step
weights name by name through it.

Layout changes:

  * Dense kernels (in, out) -> Linear weights (out, in);
  * conv kernels HWIO -> OIHW;
  * q/k/v kernels -> one packed `in_proj_weight` (and `in_proj_bias`);
  * FrozenBN buffers, norm scales and biases and embeddings copy as they
    are.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# (port state-dict key, transform); transform is one of conv, linear, copy,
# qkv_q, qkv_k, qkv_v
KeyMap = Optional[Tuple[str, str]]


def _dense(kind: str) -> Tuple[str, str]:
    """(torch leaf name, transform) of a Dense/Conv leaf `kernel`/`bias`."""
    return ("weight", "linear") if kind == "kernel" else ("bias", "copy")


def _norm(kind: str) -> str:
    return "weight" if kind == "scale" else "bias"


def _msda(rest: str, ours: str, tk: str) -> KeyMap:
    m = re.fullmatch(rf"{ours}/(sampling_offsets|attention_weights|"
                     rf"value_proj|output_proj)/(kernel|bias)", rest)
    if not m:
        return None
    name, t = _dense(m.group(2))
    return f"{tk}.{m.group(1)}.{name}", t


def _mha(rest: str, ours: str, tk: str) -> KeyMap:
    m = re.fullmatch(rf"{ours}/(q_proj|k_proj|v_proj|out_proj)/"
                     rf"(kernel|bias)", rest)
    if not m:
        return None
    mod, kind = m.groups()
    if mod == "out_proj":
        name, t = _dense(kind)
        return f"{tk}.out_proj.{name}", t
    src = "in_proj_weight" if kind == "kernel" else "in_proj_bias"
    return f"{tk}.{src}", f"qkv_{mod[0]}"


def _ffn_norm(rest: str, tk: str) -> KeyMap:
    m = re.fullmatch(r"(linear\d)/(kernel|bias)", rest)
    if m:
        name, t = _dense(m.group(2))
        return f"{tk}.{m.group(1)}.{name}", t
    m = re.fullmatch(r"(norm\d)/(scale|bias)", rest)
    if m:
        return f"{tk}.{m.group(1)}.{_norm(m.group(2))}", "copy"
    return None


def torch_key_for(path: str) -> KeyMap:
    """JAX param path ("params/a/b/kernel") -> (port key, transform), or
    None for a param the port has no place for."""
    p = path.replace("params/", "", 1)

    m = re.fullmatch(r"backbone/trunk/(.*)", p)
    if m:
        rest = re.sub(r"layer(\d)_(\d+)/", r"layer\1.\2.", m.group(1))
        rest = rest.replace("downsample_conv/", "downsample.0.")
        rest = rest.replace("downsample_bn/", "downsample.1.")
        rest = "backbone.0.body." + rest.replace("/", ".")
        if rest.endswith(".kernel"):
            return rest[:-len(".kernel")] + ".weight", "conv"
        if rest.rsplit(".", 1)[-1] in ("weight", "bias", "running_mean",
                                       "running_var"):
            return rest, "copy"
        return None

    m = re.fullmatch(r"input_proj_(\d+)/conv/(kernel|bias)", p)
    if m:
        i, kind = m.groups()
        if kind == "kernel":
            return f"input_proj.{i}.0.weight", "conv"
        return f"input_proj.{i}.0.bias", "copy"
    m = re.fullmatch(r"input_proj_(\d+)/norm/(scale|bias)", p)
    if m:
        return f"input_proj.{m.group(1)}.1.{_norm(m.group(2))}", "copy"

    embeds = {"query_embed": "query_embed.weight",
              "level_embed": "transformer.level_embed",
              "frame_embed": "transformer.frame_embed"}
    if p in embeds:
        return embeds[p], "copy"

    m = re.fullmatch(r"encoder/layer_(\d+)/(.*)", p)
    if m:
        i, rest = m.groups()
        tk = f"transformer.encoder.layers.{i}"
        return (_msda(rest, "self_attn", tk + ".self_attn")
                or _mha(rest, "self_attn", tk + ".self_attn")
                or _ffn_norm(rest, tk))
    m = re.fullmatch(r"encoder/fuse_(\d+)/(up|down|norm)_(\d+)/"
                     r"(kernel|scale|bias)", p)
    if m:
        i, mod, j, kind = m.groups()
        tk = f"transformer.encoder.fuse.{i}.{mod}.{j}"
        if mod == "norm":
            return f"{tk}.{_norm(kind)}", "copy"
        name, t = _dense(kind)
        return f"{tk}.{name}", t

    m = re.fullmatch(r"decoder_layers_(\d+)/(.*)", p)
    if m:
        i, rest = m.groups()
        tk = f"transformer.decoder.layers.{i}"
        return (_msda(rest, "cross_attn", tk + ".cross_attn")
                or _mha(rest, "self_attn", tk + ".self_attn")
                or _ffn_norm(rest, tk))

    m = re.fullmatch(r"class_embed_(\d+)/(kernel|bias)", p)
    if m:
        name, t = _dense(m.group(2))
        return f"class_embed.{m.group(1)}.{name}", t
    m = re.fullmatch(r"bbox_embed_(\d+)/layer_(\d+)/(kernel|bias)", p)
    if m:
        i, j, kind = m.groups()
        name, t = _dense(kind)
        return f"bbox_embed.{i}.layers.{j}.{name}", t
    m = re.fullmatch(r"reference_points/(kernel|bias)", p)
    if m:
        name, t = _dense(m.group(1))
        return f"transformer.reference_points.{name}", t
    return None


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
    """JAX params ({"params": {...}}), or any tree of their structure (a
    gradient tree, updated params) -> float32 tensors by the port's
    state-dict keys. Raises on a JAX parameter with no key and on a key that
    would be written twice."""
    out: Dict[str, np.ndarray] = {}
    packed: Dict[str, Dict[int, np.ndarray]] = {}
    for path, arr in flatten_tree(params).items():
        mapped = torch_key_for(path)
        if mapped is None:
            raise KeyError(f"no port key for JAX param {path}")
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
        if key in out:
            raise KeyError(f"{key} written twice")
        out[key] = np.concatenate([parts[0], parts[1], parts[2]], 0)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
