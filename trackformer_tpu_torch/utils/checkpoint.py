"""Checkpoints: portable npz params in the JAX package's layout, the
scan-layer bridge and shape-adaptive warm starts, and the train state.

Counterpart of `trackformer_tpu/utils/checkpoint.py`, on numpy and torch:

  * `flatten_params` / `unflatten_params`: nested dicts of arrays <->
    {"a/b/c": array};
  * `save_params_npz` / `load_params_npz`: the JAX param tree
    ({"params": {...}}) in an `.npz` file. The port writes the JAX layout
    (`convert.state_dict_to_jax_params`), so one file serves both
    packages: `save_model_npz` / `load_model_npz` carry a port model
    through it;
  * `bridge_scan_layout`: `tpu.scan_layers` checkpoints (layers stacked on
    a leading axis) <-> the unrolled per-layer keys the port has;
  * `adapt_params` with `resume_shift_neuron`, and `load_and_adapt`: the
    reference's shape-adaptive resume surgery, on the JAX layout;
  * `CheckpointManager`: the train state (float32 master weights, the
    AdamW moments, the update count, which is the learning-rate schedule's
    position) through `torch.save` of tensors only, plus the JAX manager's
    `meta.json`, `checkpoint_params.npz`, `checkpoint_epoch_{n}.npz` and
    `checkpoint_best_{metric}.npz`.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..convert import jax_params_to_state_dict, state_dict_to_jax_params


def flatten_params(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mappings of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_params_npz(params: Mapping, path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flatten_params(params))


def load_params_npz(path) -> Dict:
    with np.load(path, allow_pickle=False) as data:
        return unflatten_params({k: data[k] for k in data.files})


def save_model_npz(model: nn.Module, path, cfg=None) -> None:
    """A port model's weights as an `.npz` in the JAX layout, which the JAX
    package's `load_params_npz` reads into its model."""
    save_params_npz(state_dict_to_jax_params(model.state_dict(), cfg), path)


def load_model_npz(model: nn.Module, path) -> None:
    """Load an `.npz` in the JAX layout (written by either package, in the
    unrolled or the `scan_layers` layout) into a port model, every tensor
    of it, each in the model's own dtype."""
    own = flatten_params(state_dict_to_jax_params(model.state_dict()))
    loaded = bridge_scan_layout(flatten_params(load_params_npz(path)), own,
                                verbose=False)
    model.load_state_dict(jax_params_to_state_dict(unflatten_params(loaded)))


# Stacked (tpu.scan_layers) <-> unrolled per-layer key correspondence:
#   encoder/layer_{i}/R        <-> encoder/layers/layer/R       (stack axis 0)
#   decoder_layers_{i}/R       <-> dec_scan/layers/layer/R
#   class_embed_{i}/R (i<L)    <-> dec_scan/layers/class_embed/R
#   bbox_embed_{i}/R  (i<L)    <-> dec_scan/layers/bbox_embed/R
#   class_embed_{L}/R          <-> enc_class_embed/R  (two-stage extra head)
#   bbox_embed_{L}/R           <-> enc_bbox_embed/R
_SCAN_PATTERNS = [
    (r"^(?P<p>.*encoder/)layers/layer/(?P<r>.+)$", "{p}layer_{i}/{r}"),
    (r"^(?P<p>.*?)dec_scan/layers/layer/(?P<r>.+)$",
     "{p}decoder_layers_{i}/{r}"),
    (r"^(?P<p>.*?)dec_scan/layers/(?P<h>class_embed|bbox_embed)/(?P<r>.+)$",
     "{p}{h}_{i}/{r}"),
]


def _unrolled_key(stacked_key: str, index: int) -> Optional[str]:
    for pat, tmpl in _SCAN_PATTERNS:
        m = re.match(pat, stacked_key)
        if m:
            return tmpl.format(i=index, **m.groupdict())
    return None


def bridge_scan_layout(loaded: Dict[str, np.ndarray],
                       target: Dict[str, np.ndarray],
                       verbose: bool = True) -> Dict[str, np.ndarray]:
    """Convert between unrolled per-layer params (layer_0..layer_{L-1}) and
    the stacked layout of `tpu.scan_layers`, so checkpoints from either
    model mode warm-start the other. The direction is inferred per key
    from which side has the stacked name; everything else passes
    through."""
    out = dict(loaded)

    def _leading_dim(v):
        shape = getattr(v, "shape", ())
        return shape[0] if len(shape) else None

    # unrolled checkpoint -> stacked target key
    for key in target:
        if key in out or _unrolled_key(key, 0) is None:
            continue
        n = 0
        while _unrolled_key(key, n) in out:
            n += 1
        # the two-stage unrolled layout has one extra head (index L, the
        # encoder-proposal head) that must not join the stack
        n_target = _leading_dim(target[key])
        if n_target is not None:
            n = min(n, n_target)
        if n == 0:
            continue
        parts = [out[_unrolled_key(key, i)] for i in range(n)]
        for i in range(n):
            del out[_unrolled_key(key, i)]
        out[key] = np.stack(parts)
        if verbose:
            print(f"resume: stacked {n} unrolled layers -> {key}")

    # stacked checkpoint -> unrolled target keys
    for skey in [k for k in out if _unrolled_key(k, 0) is not None]:
        arr = out[skey]
        wanted = [i for i in range(arr.shape[0])
                  if _unrolled_key(skey, i) in target]
        if not wanted:
            continue
        for i in wanted:
            out[_unrolled_key(skey, i)] = arr[i]
        del out[skey]
        if verbose:
            print(f"resume: unstacked {skey} -> {len(wanted)} layer keys")

    # two-stage extra head: unrolled head index L <-> enc_{class,bbox}_embed
    for key in target:
        if key in out:
            continue
        m = re.match(r"^(?P<p>.*?)enc_(?P<h>class_embed|bbox_embed)/"
                     r"(?P<r>.+)$", key)
        if m:  # target stacked-mode, checkpoint unrolled: take max index
            cands = []
            for k in out:
                km = re.match(
                    rf"^{re.escape(m.group('p'))}{m.group('h')}_(\d+)/"
                    rf"{re.escape(m.group('r'))}$", k)
                if km:
                    cands.append((int(km.group(1)), k))
            if cands:
                _, src = max(cands)
                out[key] = out.pop(src)
                if verbose:
                    print(f"resume: {src} -> {key}")
            continue
        m = re.match(r"^(?P<p>.*?)(?P<h>class_embed|bbox_embed)_(?P<i>\d+)/"
                     r"(?P<r>.+)$", key)
        if m:  # target unrolled, checkpoint stacked-mode: extra head index
            src = f"{m.group('p')}enc_{m.group('h')}/{m.group('r')}"
            if src in out:
                out[key] = out.pop(src)
                if verbose:
                    print(f"resume: {src} -> {key}")
    return out


def _out_axis(key: str, arr: np.ndarray) -> int:
    """Axis holding the original's "dim 0" (output features) in the JAX
    layout: kernels are (in, out) / HWIO, so it is the last axis; biases,
    scales and embeddings keep it first."""
    return arr.ndim - 1 if key.endswith("/kernel") else 0


def _take_out(arr: np.ndarray, axis: int, n: int) -> np.ndarray:
    return np.take(arr, np.arange(n), axis=axis)


def adapt_params(loaded: Dict[str, np.ndarray],
                 target: Dict[str, np.ndarray],
                 resume_shift_neuron: bool = False,
                 verbose: bool = True) -> Dict[str, np.ndarray]:
    """Shape-adaptive warm start with the reference's surgery rules, in the
    JAX layout (the original's dim 0 = a kernel's last axis):

      * 'norm'                      -> repeat(2)
      * 'self_attn'/'multihead_attn'-> repeat 2 on every dim
      * 'reference_points' (out x2) -> fresh, prefix = loaded
      * 'linear1'/'query_embed'     -> fresh init
      * 'linear2'/'input_proj'      -> repeat 2 on the out axis
      * 'class_embed'               -> slice leading classes
      * resume_shift_neuron (equal shapes, class head): rotate class
        neurons so label 0 sits at neuron 0

    Unmatched mismatches fall back to a generic slice or pad (and say so).
    """
    loaded = bridge_scan_layout(loaded, target, verbose=verbose)
    out = dict(target)
    for key, tgt in target.items():
        if key not in loaded:
            if verbose:
                print(f"resume: {key} {tgt.shape} from scratch "
                      f"(not in checkpoint)")
            continue
        src = loaded[key]
        ax = _out_axis(key, tgt)
        if src.shape == tgt.shape:
            if resume_shift_neuron and "class_embed" in key:
                moved = np.moveaxis(np.array(src), ax, 0)
                shifted = moved.copy()
                shifted[:-1] = moved[1:]
                shifted[-2] = moved[0]
                out[key] = np.ascontiguousarray(
                    np.moveaxis(shifted, 0, ax)).astype(tgt.dtype)
                if verbose:
                    print(f"resume: {key} class neurons shifted so label 0 "
                          f"sits at neuron 0")
            else:
                out[key] = src.astype(tgt.dtype)
            continue

        val = None
        if "norm" in key and src.ndim == 1:
            val = np.tile(src, 2)
        elif "self_attn" in key or "multihead_attn" in key:
            val = np.tile(src, (2,) * src.ndim)
        elif "reference_points" in key and \
                src.shape[ax] * 2 == tgt.shape[ax]:
            val = np.moveaxis(np.array(tgt), ax, 0)
            val[:src.shape[ax]] = np.moveaxis(src, ax, 0)
            val = np.moveaxis(val, 0, ax)
        elif "linear1" in key or "query_embed" in key:
            if verbose:
                print(f"resume: {key} {tgt.shape} from scratch")
            continue
        elif "linear2" in key or "input_proj" in key:
            reps = [1] * src.ndim
            reps[ax] = 2
            val = np.tile(src, reps)
        elif "class_embed" in key and src.shape[ax] >= tgt.shape[ax]:
            val = _take_out(src, ax, tgt.shape[ax])

        if val is not None and val.shape == tgt.shape:
            out[key] = val.astype(tgt.dtype)
            if verbose:
                print(f"resume: {key} {tgt.shape} adapted from "
                      f"{src.shape}")
            continue

        # generic fallback (the reference raises NotImplementedError here)
        if all(s >= t for s, t in zip(src.shape, tgt.shape)):
            sl = tuple(slice(0, t) for t in tgt.shape)
            out[key] = src[sl].astype(tgt.dtype)
            if verbose:
                print(f"resume: sliced {key} {src.shape} -> {tgt.shape}")
        elif all(s <= t for s, t in zip(src.shape, tgt.shape)):
            pad = np.array(tgt)
            sl = tuple(slice(0, s) for s in src.shape)
            pad[sl] = src
            out[key] = pad
            if verbose:
                print(f"resume: padded {key} {src.shape} -> {tgt.shape}")
        elif verbose:
            print(f"resume: kept fresh init for {key} "
                  f"(loaded {src.shape}, need {tgt.shape})")
    return out


def load_and_adapt(path, target_params: Mapping, **kw) -> Dict:
    """An `.npz` adapted to the JAX-layout tree `target_params` (for a port
    model: `state_dict_to_jax_params(model.state_dict())`)."""
    loaded = flatten_params(load_params_npz(path))
    target = flatten_params(target_params)
    return unflatten_params(adapt_params(loaded, target, **kw))


class CheckpointManager:
    """Epoch checkpoints of the train state and per-metric best copies of
    the weights. The state goes through `torch.save` (tensors and ints
    only, read back with `weights_only=True`) as `checkpoint.pt`; the
    weights also as `.npz` files in the JAX layout."""

    def __init__(self, output_dir, save_interval: int = 5):
        self.dir = Path(output_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_interval = save_interval
        self.best: Dict[str, float] = {}

    def _meta_path(self) -> Path:
        return self.dir / "meta.json"

    def _state_path(self) -> Path:
        return self.dir / "checkpoint.pt"

    def save(self, state, epoch: int, val_stats: Optional[Dict] = None,
             config=None) -> None:
        """`state`: the port's `TrainState`. `config`, the model's
        `FlagshipConfig` if given, checks that the weights are its
        model's."""
        params = state_dict_to_jax_params(state.params, config)
        tmp = self._state_path().with_suffix(".tmp")
        torch.save({"params": state.params, "mu": state.mu,
                    "nu": state.nu, "step": int(state.step)}, tmp)
        tmp.replace(self._state_path())
        meta = {"epoch": epoch, "best": self.best}
        self._meta_path().write_text(json.dumps(meta))
        save_params_npz(params, self.dir / "checkpoint_params.npz")
        if self.save_interval and epoch % self.save_interval == 0:
            save_params_npz(params,
                            self.dir / f"checkpoint_epoch_{epoch}.npz")
        # per-metric best checkpoints
        for metric, value in (val_stats or {}).items():
            if value >= self.best.get(metric, float("-inf")):
                self.best[metric] = float(value)
                save_params_npz(
                    params, self.dir / f"checkpoint_best_{metric}.npz")

    def restore(self, state, model: Optional[nn.Module] = None):
        """-> (state, epoch): the saved tensors copied into `state` in
        place, on its device, and (given) into `model`, whose parameters
        are the cast copy of the master weights when it computes in
        bfloat16. Without a checkpoint: (state, 0)."""
        if not self._state_path().exists():
            return state, 0
        device = next(iter(state.params.values())).device
        saved = torch.load(self._state_path(), map_location=device,
                           weights_only=True)
        with torch.no_grad():
            for name in ("params", "mu", "nu"):
                own, got = getattr(state, name), saved[name]
                if set(own) != set(got):
                    raise KeyError(f"checkpoint {name} keys differ from the "
                                   f"state's: {sorted(set(own) ^ set(got))}")
                for key, t in own.items():
                    t.copy_(got[key])
            if model is not None:
                from ..engine.train_step import train_tensors
                for key, t in train_tensors(model).items():
                    if t.data_ptr() != state.params[key].data_ptr():
                        t.copy_(state.params[key])
        state.step = int(saved["step"])
        meta = json.loads(self._meta_path().read_text()) \
            if self._meta_path().exists() else {}
        self.best = meta.get("best", {})
        return state, int(meta.get("epoch", 0))
