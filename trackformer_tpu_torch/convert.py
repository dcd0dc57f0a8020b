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
  * `frame_embed` -> `transformer.frame_embed`;

the Deformable family's other switches under the original TrackFormer
keys: the two-stage `enc_output`, `enc_output_norm`, `pos_trans` and
`pos_trans_norm` -> `transformer.{...}` (the proposals' head is the last
`class_embed.{i}` / `bbox_embed.{i}`; `enc_class_embed` of a `scan_layers`
model comes through `utils/checkpoint.py:bridge_scan_layout`),
`merge_features_l` -> `merge_features.{l}`, and the dense decoder's
`decoder_layers_i/cross_attn/{q,k,v}_proj` packed into
`transformer.decoder.layers.{i}.cross_attn.in_proj_*` as torch's
`nn.MultiheadAttention` lays it out;

and with vanilla DETR's (`input_proj`, `transformer/{encoder,decoder,
track_attention}_layer_i`, `transformer/{encoder,decoder}_norm`,
`class_embed`, `bbox_embed/layer_j`) and the mask heads' of both families
(`bbox_attention/{q,k}_linear`, `mask_head/lay1..5`, `gn1..5`,
`adapter1..3`, `out_lay`). Several JAX paths of the two families share a
port key (an encoder layer's `linear1`, say); the inverse tells them apart
by the state dict's own keys (`input_proj.weight` is vanilla DETR's).

The map is linear (transposes and the q/k/v packing), so the same function
carries a JAX gradient tree, or the params after an optimizer update, to
the port's names: the training tests compare gradients and post-step
weights name by name through it.

`state_dict_to_jax_params` is the inverse: the port's `state_dict` (or any
dict of its keys) back to the JAX param tree as numpy float32, without JAX
and without a template tree. `jax_path_for` names each key's JAX path(s);
every answer is checked against `torch_key_for`, so the two directions
cannot drift apart. The round trip is exact: the map only transposes and
splits.

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
    m = re.fullmatch(r"(enc_output|pos_trans)/(kernel|bias)", p)
    if m:
        name, t = _dense(m.group(2))
        return f"transformer.{m.group(1)}.{name}", t
    m = re.fullmatch(r"(enc_output_norm|pos_trans_norm)/(scale|bias)", p)
    if m:
        return f"transformer.{m.group(1)}.{_norm(m.group(2))}", "copy"
    m = re.fullmatch(r"merge_features_(\d+)/(kernel|bias)", p)
    if m:
        i, kind = m.groups()
        return ((f"merge_features.{i}.weight", "conv") if kind == "kernel"
                else (f"merge_features.{i}.bias", "copy"))

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
                or _mha(rest, "cross_attn", tk + ".cross_attn")
                or _mha(rest, "self_attn", tk + ".self_attn")
                or _ffn_norm(rest, tk))

    m = re.fullmatch(r"input_proj/(kernel|bias)", p)
    if m:
        return (("input_proj.weight", "conv") if m.group(1) == "kernel"
                else ("input_proj.bias", "copy"))
    m = re.fullmatch(r"transformer/(encoder|decoder|track_attention)_layer_"
                     r"(\d+)/(.*)", p)
    if m:
        which, i, rest = m.groups()
        tk = (f"transformer.decoder.layers_track_attention.{i}"
              if which == "track_attention"
              else f"transformer.{which}.layers.{i}")
        return (_mha(rest, "self_attn", tk + ".self_attn")
                or _mha(rest, "multihead_attn", tk + ".multihead_attn")
                or _ffn_norm(rest, tk))
    m = re.fullmatch(r"transformer/(encoder|decoder)_norm/(scale|bias)", p)
    if m:
        return (f"transformer.{m.group(1)}.norm.{_norm(m.group(2))}",
                "copy")

    m = re.fullmatch(r"class_embed(?:_(\d+))?/(kernel|bias)", p)
    if m:
        i, kind = m.groups()
        name, t = _dense(kind)
        return f"class_embed.{i + '.' if i else ''}{name}", t
    m = re.fullmatch(r"bbox_embed(?:_(\d+))?/layer_(\d+)/(kernel|bias)", p)
    if m:
        i, j, kind = m.groups()
        name, t = _dense(kind)
        return f"bbox_embed.{i + '.' if i else ''}layers.{j}.{name}", t
    m = re.fullmatch(r"bbox_attention/(q_linear|k_linear)/(kernel|bias)", p)
    if m:
        name, t = _dense(m.group(2))
        return f"bbox_attention.{m.group(1)}.{name}", t
    m = re.fullmatch(r"mask_head/(lay\d|adapter\d|out_lay)/(kernel|bias)", p)
    if m:
        mod, kind = m.groups()
        return (f"mask_head.{mod}.weight", "conv") if kind == "kernel" \
            else (f"mask_head.{mod}.bias", "copy")
    m = re.fullmatch(r"mask_head/(gn\d)/(scale|bias)", p)
    if m:
        return f"mask_head.{m.group(1)}.{_norm(m.group(2))}", "copy"
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


def _dense_leaf(leaf: str) -> Tuple[str, str]:
    """(JAX leaf, transform) of a Linear's `weight` / `bias`."""
    return ("kernel", "linear") if leaf == "weight" else ("bias", "copy")


def _norm_leaf(leaf: str) -> Tuple[str, str]:
    return ("scale" if leaf == "weight" else "bias"), "copy"


def _attn_paths(prefix: str, rest: str):
    """JAX paths under an attention module `prefix` for the port's `rest`
    (MSDA projections, packed q/k/v, the out projection)."""
    m = re.fullmatch(r"(sampling_offsets|attention_weights|value_proj|"
                     r"output_proj|out_proj)\.(weight|bias)", rest)
    if m:
        leaf, t = _dense_leaf(m.group(2))
        return [(f"{prefix}/{m.group(1)}/{leaf}", t)]
    m = re.fullmatch(r"in_proj_(weight|bias)", rest)
    if m:
        leaf = "kernel" if m.group(1) == "weight" else "bias"
        return [(f"{prefix}/{c}_proj/{leaf}", f"qkv_{c}") for c in "qkv"]
    return None


def _layer_paths(prefix: str, rest: str, attn: Tuple[str, ...]):
    """JAX paths of an encoder or decoder layer's `rest`."""
    head, _, tail = rest.partition(".")
    if head in attn:
        return _attn_paths(f"{prefix}/{head}", tail)
    m = re.fullmatch(r"(linear\d)\.(weight|bias)", rest)
    if m:
        leaf, t = _dense_leaf(m.group(2))
        return [(f"{prefix}/{m.group(1)}/{leaf}", t)]
    m = re.fullmatch(r"(norm\d)\.(weight|bias)", rest)
    if m:
        leaf, t = _norm_leaf(m.group(2))
        return [(f"{prefix}/{m.group(1)}/{leaf}", t)]
    return None


def _vanilla_jax_paths(key: str):
    """JAX paths of a vanilla DETR key that the Deformable family's keys
    do not share."""
    if key in ("input_proj.weight", "input_proj.bias"):
        return [("input_proj/kernel", "conv") if key.endswith("weight")
                else ("input_proj/bias", "copy")]
    m = re.fullmatch(r"transformer\.(encoder|decoder)\.norm\.(weight|bias)",
                     key)
    if m:
        leaf, t = _norm_leaf(m.group(2))
        return [(f"transformer/{m.group(1)}_norm/{leaf}", t)]
    m = re.fullmatch(r"transformer\.(encoder|decoder)\.layers\.(\d+)\.(.*)",
                     key)
    if m:
        which, i, rest = m.groups()
        return _layer_paths(f"transformer/{which}_layer_{i}", rest,
                            ("self_attn", "multihead_attn"))
    m = re.fullmatch(r"transformer\.decoder\.layers_track_attention\.(\d+)"
                     r"\.(.*)", key)
    if m:
        return _layer_paths(f"transformer/track_attention_layer_{m.group(1)}",
                            m.group(2), ("self_attn",))
    m = re.fullmatch(r"class_embed\.(weight|bias)", key)
    if m:
        leaf, t = _dense_leaf(m.group(1))
        return [(f"class_embed/{leaf}", t)]
    m = re.fullmatch(r"bbox_embed\.layers\.(\d+)\.(weight|bias)", key)
    if m:
        leaf, t = _dense_leaf(m.group(2))
        return [(f"bbox_embed/layer_{m.group(1)}/{leaf}", t)]
    return None


def _segm_jax_paths(key: str):
    """JAX paths of a mask-head key (both families)."""
    m = re.fullmatch(r"bbox_attention\.(q_linear|k_linear)\.(weight|bias)",
                     key)
    if m:
        leaf, t = _dense_leaf(m.group(2))
        return [(f"bbox_attention/{m.group(1)}/{leaf}", t)]
    m = re.fullmatch(r"mask_head\.(lay\d|adapter\d|out_lay)\.(weight|bias)",
                     key)
    if m:
        mod, leaf = m.groups()
        return [(f"mask_head/{mod}/kernel", "conv") if leaf == "weight"
                else (f"mask_head/{mod}/bias", "copy")]
    m = re.fullmatch(r"mask_head\.(gn\d)\.(weight|bias)", key)
    if m:
        leaf, t = _norm_leaf(m.group(2))
        return [(f"mask_head/{m.group(1)}/{leaf}", t)]
    return None


def _unchecked_jax_paths(key: str, vanilla: bool = False):
    paths = _segm_jax_paths(key)
    if paths or vanilla:
        paths = paths or _vanilla_jax_paths(key)
        if paths:
            return paths
    m = re.fullmatch(r"backbone\.0\.body\.(.*)", key)
    if m:
        rest = re.sub(r"layer(\d)\.(\d+)\.", r"layer\1_\2/", m.group(1))
        rest = rest.replace("downsample.0.", "downsample_conv/")
        rest = rest.replace("downsample.1.", "downsample_bn/")
        module, _, leaf = rest.replace(".", "/").rpartition("/")
        conv = re.search(r"(^|/)(conv\d|downsample_conv)$", module)
        if conv and leaf == "weight":
            return [(f"backbone/trunk/{module}/kernel", "conv")]
        return [(f"backbone/trunk/{module}/{leaf}", "copy")]
    m = re.fullmatch(r"input_proj\.(\d+)\.([01])\.(weight|bias)", key)
    if m:
        i, part, leaf = m.groups()
        if part == "0":
            return [(f"input_proj_{i}/conv/kernel", "conv") if leaf == "weight"
                    else (f"input_proj_{i}/conv/bias", "copy")]
        leaf, t = _norm_leaf(leaf)
        return [(f"input_proj_{i}/norm/{leaf}", t)]
    embeds = {"query_embed.weight": "query_embed",
              "transformer.level_embed": "level_embed",
              "transformer.frame_embed": "frame_embed"}
    if key in embeds:
        return [(embeds[key], "copy")]
    m = re.fullmatch(r"transformer\.(enc_output|pos_trans)\.(weight|bias)",
                     key)
    if m:
        leaf, t = _dense_leaf(m.group(2))
        return [(f"{m.group(1)}/{leaf}", t)]
    m = re.fullmatch(r"transformer\.(enc_output_norm|pos_trans_norm)\."
                     r"(weight|bias)", key)
    if m:
        leaf, t = _norm_leaf(m.group(2))
        return [(f"{m.group(1)}/{leaf}", t)]
    m = re.fullmatch(r"merge_features\.(\d+)\.(weight|bias)", key)
    if m:
        i, leaf = m.groups()
        return [(f"merge_features_{i}/kernel", "conv") if leaf == "weight"
                else (f"merge_features_{i}/bias", "copy")]
    m = re.fullmatch(r"transformer\.encoder\.layers\.(\d+)\.(.*)", key)
    if m:
        return _layer_paths(f"encoder/layer_{m.group(1)}", m.group(2),
                            ("self_attn",))
    m = re.fullmatch(r"transformer\.encoder\.fuse\.(\d+)\.(up|down|norm)\."
                     r"(\d+)\.(weight|bias)", key)
    if m:
        i, mod, j, leaf = m.groups()
        leaf, t = (_norm_leaf if mod == "norm" else _dense_leaf)(leaf)
        return [(f"encoder/fuse_{i}/{mod}_{j}/{leaf}", t)]
    m = re.fullmatch(r"transformer\.decoder\.layers\.(\d+)\.(.*)", key)
    if m:
        return _layer_paths(f"decoder_layers_{m.group(1)}", m.group(2),
                            ("self_attn", "cross_attn"))
    m = re.fullmatch(r"class_embed\.(\d+)\.(weight|bias)", key)
    if m:
        leaf, t = _dense_leaf(m.group(2))
        return [(f"class_embed_{m.group(1)}/{leaf}", t)]
    m = re.fullmatch(r"bbox_embed\.(\d+)\.layers\.(\d+)\.(weight|bias)", key)
    if m:
        leaf, t = _dense_leaf(m.group(3))
        return [(f"bbox_embed_{m.group(1)}/layer_{m.group(2)}/{leaf}", t)]
    m = re.fullmatch(r"transformer\.reference_points\.(weight|bias)", key)
    if m:
        leaf, t = _dense_leaf(m.group(1))
        return [(f"reference_points/{leaf}", t)]
    return None


def jax_path_for(key: str, vanilla: bool = False):
    """Port state-dict key -> [(JAX param path without "params/",
    transform)]: one path, or three for a packed `in_proj_*` (q, k, v in
    order); `vanilla` for a key of a vanilla DETR model. Raises KeyError for
    a key with no JAX path; every path is checked to map back to `key`
    through `torch_key_for`."""
    paths = _unchecked_jax_paths(key, vanilla)
    if not paths:
        raise KeyError(f"no JAX param for port key {key}")
    for path, transform in paths:
        if torch_key_for("params/" + path) != (key, transform):
            raise KeyError(f"no JAX param for port key {key}")
    return paths


def _check_layout(keys, cfg) -> None:
    """Raise unless `keys` are those of a model built from `cfg`: its
    family, mask head, encoder mode and layer counts."""
    def count(pattern):
        return len({m.group(1) for k in keys
                    for m in [re.match(pattern, k)] if m})

    got = {"encoder layers": count(r"transformer\.encoder\.layers\.(\d+)\."),
           "decoder layers": count(r"transformer\.decoder\.layers\.(\d+)\."),
           "class heads": count(r"class_embed\.(\d+)\."),
           "frame_embed": int("transformer.frame_embed" in keys),
           "vanilla": int("input_proj.weight" in keys),
           "mask head": int("mask_head.out_lay.weight" in keys),
           "two-stage": int("transformer.pos_trans.weight" in keys),
           "input projections": count(r"input_proj\.(\d+)\."),
           "merged levels": count(r"merge_features\.(\d+)\."),
           "dense decoder": int(any(re.match(r"transformer\.decoder\.layers"
                                             r"\.\d+\.cross_attn\.in_proj",
                                             k) for k in keys))}
    # the cached memory takes effect on a multi-frame model with a separate
    # encoder (`models.factory.cached_mode`); without box refinement one
    # head serves every decoder layer
    cached = (cfg.cached_prev_memory and cfg.multi_frame_attention
              and cfg.multi_frame_attention_separate_encoder
              and not cfg.merge_frame_features)
    two_stage = bool(cfg.two_stage)
    levels = cfg.num_feature_levels
    want = {"encoder layers": cfg.enc_layers,
            "decoder layers": cfg.dec_layers,
            "class heads": (cfg.dec_layers + int(two_stage)
                            if cfg.with_box_refine else 1),
            "frame_embed": int(bool(cached)),
            "vanilla": int(not cfg.deformable),
            "mask head": int(bool(cfg.masks)),
            "two-stage": int(two_stage),
            "input projections": levels,
            "merged levels": (min(4, levels) if cfg.merge_frame_features
                              else 0),
            "dense decoder": int(cfg.decoder_attention == "dense")}
    if not cfg.deformable:
        # one class head, unindexed; no cached memory
        want.update({"class heads": 0, "frame_embed": 0, "two-stage": 0,
                     "input projections": 0, "merged levels": 0,
                     "dense decoder": 0})
    if got != want:
        raise ValueError(f"state dict does not fit the config: {got} against "
                         f"{want}")


def state_dict_to_jax_params(state_dict: Mapping, cfg=None) -> Dict:
    """The port's state dict (tensors or arrays by its keys) -> the JAX
    param tree {"params": {...}} of numpy float32: Linear weights
    transposed to (in, out), OIHW convolutions to HWIO, each packed
    `in_proj_weight` / `in_proj_bias` split into q_proj, k_proj and v_proj.
    The inverse of `jax_params_to_state_dict`. Raises on a key with no JAX
    path and, given the `FlagshipConfig` of the model, on keys that are not
    that model's. A state dict with `input_proj.weight` is vanilla DETR's,
    whose keys map to its own JAX paths."""
    if cfg is not None:
        _check_layout(set(state_dict), cfg)
    vanilla = "input_proj.weight" in state_dict
    tree: Dict = {}
    for key, value in state_dict.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().to("cpu", torch.float32).numpy()
        a = np.asarray(value, dtype=np.float32)
        paths = jax_path_for(key, vanilla)
        parts = np.split(a, 3, 0) if len(paths) == 3 else [a]
        for (path, transform), part in zip(paths, parts):
            if transform == "conv":
                part = part.transpose(2, 3, 1, 0)
            elif transform == "linear" or (transform.startswith("qkv_")
                                           and part.ndim == 2):
                part = part.T
            node = tree.setdefault("params", {})
            *parents, leaf = path.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            if leaf in node:
                raise KeyError(f"JAX param {path} written twice")
            node[leaf] = np.ascontiguousarray(part)
    return tree
