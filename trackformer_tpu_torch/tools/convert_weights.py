"""Load an original TrackFormer / Deformable DETR / DETR `.pth` onto the
port's model, without JAX.

Counterpart of `tools/convert_weights.py`, which converts through the JAX
model's parameter tree. The port keeps the original checkpoints' key names
(`convert.py`), so the map is direct: each tensor of the checkpoint's
`model` entry (or of the checkpoint itself), with `module.` and a leading
`detr.` stripped as the JAX tool strips them, goes to the port's tensor of
that key, in the port's layout already (Linear `(out, in)`, conv OIHW,
packed `in_proj`). The coverage report is the JAX tool's: the port's
tensors left unmapped (kept at their init), the checkpoint's tensors left
unused, and the shapes that differ (kept at their init).

Usage:
  python -m trackformer_tpu_torch.tools.convert_weights checkpoint.pth \\
      out.npz [--config config.yaml | --named-configs deformable ...] \\
      [--state-dict out.pt]
writes the weights as an `.npz` in the JAX package's layout (what the
port's CLIs load, through `convert.py`) and, with `--state-dict`, the
port's state dict (`torch.save`).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class Coverage:
    """What a load left out: the port's keys without a tensor, the
    checkpoint's keys not used, and the keys whose shapes differ."""
    unmapped: List[str]
    unused: List[str]
    mismatched: List[str]

    @property
    def empty(self) -> bool:
        return not (self.unmapped or self.unused or self.mismatched)


def clean_keys(state: Mapping) -> Dict[str, np.ndarray]:
    """The checkpoint's tensors by the port's key: `module.` and a leading
    `detr.` stripped; entries that are not tensors dropped."""
    out = {}
    for k, v in state.items():
        if not hasattr(v, "shape"):
            continue
        k = k.replace("module.", "")
        if k.startswith("detr."):
            k = k[len("detr."):]
        out[k] = v
    return out


def load_pth_state(model: nn.Module, checkpoint: Mapping,
                   verbose: bool = True) -> Coverage:
    """Copy an original checkpoint (`{"model": state_dict, ...}` or the
    state dict itself) into `model` -> the coverage report."""
    state = clean_keys(checkpoint.get("model", checkpoint))
    own = model.state_dict()
    unmapped, mismatched, used = [], [], set()
    loaded = {}
    for key, target in own.items():
        if key not in state:
            unmapped.append(key)
            continue
        value = torch.as_tensor(np.asarray(state[key]))
        if tuple(value.shape) != tuple(target.shape):
            mismatched.append(key)
            continue
        used.add(key)
        loaded[key] = value.to(target.dtype)
    with torch.no_grad():
        for key, value in loaded.items():
            own[key].copy_(value)
    report = Coverage(unmapped, sorted(set(state) - used), mismatched)
    if verbose:
        for key in report.unmapped:
            print(f"  unmapped (port): {key}")
        for key in report.mismatched:
            print(f"  SHAPE MISMATCH {key}: checkpoint "
                  f"{tuple(np.shape(state[key]))} vs port "
                  f"{tuple(own[key].shape)} - keeping init")
        for key in report.unused:
            print(f"  unused (checkpoint): {key}")
        print(f"converted {len(used)}/{len(own)} port tensors")
    return report


def read_pth(path) -> Mapping:
    """An original checkpoint on the CPU. It holds the run's `args`
    namespace besides the tensors, hence no `weights_only`: load only
    checkpoints you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def main(argv=None):
    import yaml

    from ..models import build_model
    from ..utils.checkpoint import save_model_npz
    from ..utils.config import FlagshipConfig, load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("dst", help="the weights as an .npz in the JAX layout")
    ap.add_argument("--config", default=None,
                    help="train config.yaml describing the model")
    ap.add_argument("--named-configs", nargs="*", default=["deformable"])
    ap.add_argument("--state-dict", default=None,
                    help="also write the port's state dict here")
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = load_config("train.yaml", args.named_configs)
    model_cfg = FlagshipConfig.from_config(cfg)
    model = build_model(model_cfg, "cpu")[0]
    report = load_pth_state(model, read_pth(args.src))
    save_model_npz(model, args.dst, model_cfg)
    print(f"wrote {args.dst}")
    if args.state_dict:
        torch.save(model.state_dict(), args.state_dict)
        print(f"wrote {args.state_dict}")
    return report


if __name__ == "__main__":
    main()
