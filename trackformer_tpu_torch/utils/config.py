"""The flagship configuration as a dataclass.

It holds the values that the JAX package's
`load_config("train.yaml", ["deformable", "tracking", "multi_frame"])`
gives, together with `cfgs/track.yaml`, so a model of the main path can
be built without a config file. `FlagshipConfig.tpu_fast()` adds
the named config `tpu_fast` (`cfgs/tpu_fast.yaml`): the windowed encoder
with the cached previous-frame memory. The training fields (optimizer,
loss and matcher coefficients, track-query augmentation) are train.yaml's
too. Tests hold every field of both against
`trackformer_tpu.utils.config.load_config`.

The YAML half is the port's copy of the JAX module's: the configs under
`cfgs/` (copies of the JAX package's), `load_config` with named configs
(`{base}_{name}.yaml` first, then `{name}.yaml`), the sacred-style
`with name key=value` command line (`parse_cli`), `dump_config`, and the
namespace helpers. `FlagshipConfig.from_config` maps a loaded train config
onto the dataclass; `models.build_model` refuses what is not ported.
"""
from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml

CFG_DIR = Path(__file__).resolve().parent.parent / "cfgs"


def _default_tracker_cfg() -> Dict[str, Any]:
    # cfgs/track.yaml `tracker_cfg`
    return {
        "public_detections": False,
        "detection_obj_score_thresh": 0.4,
        "track_obj_score_thresh": 0.4,
        "detection_nms_thresh": 0.9,
        "track_nms_thresh": 0.9,
        "steps_termination": 1,
        "prev_frame_dist": 1,
        "inactive_patience": -1,
        "reid_sim_threshold": 0.0,
        "reid_sim_only": False,
        "reid_score_thresh": 0.4,
        "reid_greedy_matching": False,
    }


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
    # --- train.yaml with the named configs deformable, tracking,
    # multi_frame (keys as in the YAML) ---
    dataset: str = "coco"
    deformable: bool = True
    backbone: str = "resnet50"
    dilation: bool = False
    position_embedding: str = "sine"
    num_feature_levels: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 1024
    hidden_dim: int = 288
    nheads: int = 8
    num_queries: int = 500
    enc_n_points: int = 4
    dec_n_points: int = 4
    with_box_refine: bool = True
    two_stage: bool = False
    masks: bool = False
    focal_loss: bool = True
    aux_loss: bool = True
    overflow_boxes: bool = True
    tracking: bool = True
    multi_frame_attention: bool = True
    multi_frame_encoding: bool = True
    multi_frame_attention_separate_encoder: bool = True
    merge_frame_features: bool = False
    # vanilla DETR (`deformable: false`): pre-norm layers and the
    # dedicated track-query attention layers
    pre_norm: bool = False
    track_attention: bool = False
    # --- training (same YAML): optimization, matcher costs, losses,
    # track-query augmentation ---
    lr: float = 0.0002
    lr_backbone: float = 0.00002
    lr_linear_proj_mult: float = 0.1
    lr_track: float = 0.0001
    batch_size: int = 2
    weight_decay: float = 0.0001
    lr_drop: int = 40            # epoch of the x0.1 learning-rate drop
    clip_max_norm: float = 0.1
    dropout: float = 0.1
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    eos_coef: float = 0.1
    mask_loss_coef: float = 1.0
    dice_loss_coef: float = 1.0
    # declared on the Segm models of the JAX package, which read it nowhere
    # (the original freezes all but the mask head): no effect here either
    freeze_detr: bool = False
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    track_query_false_positive_prob: float = 0.1
    track_query_false_negative_prob: float = 0.4
    track_query_false_positive_eos_weight: bool = True
    track_backprop_prev_frame: bool = False
    track_prev_prev_frame: bool = False
    # train.yaml `tpu:` training knobs: target slots per image, linear
    # learning-rate warmup steps (0 = off)
    max_objects: int = 100
    lr_warmup_steps: int = 0
    # train.yaml `tpu:` architecture knobs of the exact-MSDA mode
    encoder_attention: str = "msda"
    decoder_attention: str = "msda"
    scan_layers: bool = False
    cached_prev_memory: bool = False
    # recompute the exact encoder's layers (and a scan_layers decoder's)
    # in a training step's backward. train.yaml turns it on (the train
    # CLI reads it from there); the dataclass keeps it off, so that a
    # model built from the defaults trains without the recompute unless
    # asked
    remat: bool = False
    # window side in tokens of the windowed encoder (the JAX factory's
    # default; cfgs/tpu_fast.yaml sets the same)
    encoder_window: int = 8
    # eval transform (train.yaml `img_transform`) and the image bucket it
    # pads to (train.yaml `tpu.image_buckets`)
    val_width: int = 800
    max_size: int = 1333
    image_bucket: Tuple[int, int] = (800, 1344)
    # --- track.yaml ---
    tracker_cfg: Dict[str, Any] = dataclasses.field(
        default_factory=_default_tracker_cfg)
    max_tracks: int = 150
    compute_dtype: str = "bfloat16"

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "FlagshipConfig":
        """A train config (`load_config("train.yaml", ...)`, or the
        `config.yaml` saved beside a checkpoint) -> the dataclass: its
        top-level keys by name, `img_transform.*`, the `tpu.*` knobs, and
        the first of `tpu.image_buckets` that holds the eval transform's
        largest frame. Keys the dataclass does not hold are ignored."""
        tpu = cfg.get("tpu") or {}
        img = cfg.get("img_transform") or {}
        kw = {k: v for k, v in cfg.items()
              if k in _FIELDS and k not in _NOT_TOP_LEVEL}
        kw.update({k: tpu[k] for k in _TPU_KEYS if k in tpu})
        kw.update({k: img[k] for k in ("val_width", "max_size") if k in img})
        for k, v in kw.items():
            default = _FIELDS[k]
            if isinstance(default, float) and isinstance(v, int) \
                    and not isinstance(v, bool):
                kw[k] = float(v)
        buckets = [tuple(b) for b in tpu.get("image_buckets") or ()]
        if buckets:
            h = kw.get("val_width", cls.val_width)
            w = kw.get("max_size", cls.max_size)
            fit = [b for b in buckets if b[0] >= h and b[1] >= w]
            kw["image_bucket"] = fit[0] if fit else buckets[-1]
        return cls(**kw)

    def replace(self, **changes) -> "FlagshipConfig":
        return dataclasses.replace(self, **changes)

    @classmethod
    def tpu_fast(cls, **changes) -> "FlagshipConfig":
        """The flagship with the named config `tpu_fast` on top: windowed
        encoder, exact-MSDA decoder, cached previous-frame memory, and the
        learning-rate warmup that its deep windowed encoder needs."""
        return cls(encoder_attention="windowed", encoder_window=8,
                   decoder_attention="msda", cached_prev_memory=True,
                   lr_warmup_steps=1000, **changes)


# field -> default (None for a field with a factory)
_FIELDS = {f.name: (None if f.default is dataclasses.MISSING else f.default)
           for f in dataclasses.fields(FlagshipConfig)}
# fields a train config holds under `tpu:`
_TPU_KEYS = ("encoder_attention", "decoder_attention", "scan_layers",
             "remat", "cached_prev_memory", "encoder_window", "max_objects",
             "lr_warmup_steps", "compute_dtype", "max_tracks")
_NOT_TOP_LEVEL = set(_TPU_KEYS) | {"val_width", "max_size", "image_bucket",
                                   "tracker_cfg"}


# --------------------------------------------------------------------------
# YAML configs and the command line
# --------------------------------------------------------------------------

def _deep_update(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _parse_value(text: str) -> Any:
    """Parse a CLI override value: int, float ('1e-4' included; YAML 1.1
    would keep it a string), then YAML scalar rules (true/null/lists)."""
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _set_dotted(cfg: Dict[str, Any], key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise KeyError(f"cannot set {key}: {p} is not a mapping")
    node[parts[-1]] = value


def load_config(base: str = "train.yaml",
                named_configs: Sequence[str] = (),
                overrides: Optional[Dict[str, Any]] = None,
                cfg_dir: Optional[Path] = None) -> Dict[str, Any]:
    """Load the base YAML, apply named configs in order, then dotted
    overrides."""
    cfg_dir = Path(cfg_dir) if cfg_dir else CFG_DIR
    with open(cfg_dir / base) as f:
        cfg = yaml.safe_load(f) or {}
    for name in named_configs:
        path = cfg_dir / f"{base.split('.')[0]}_{name}.yaml"
        if not path.exists():
            path = cfg_dir / f"{name}.yaml"
        if not path.exists():
            raise FileNotFoundError(
                f"named config '{name}' not found in {cfg_dir}")
        with open(path) as f:
            _deep_update(cfg, yaml.safe_load(f) or {})
    for key, value in (overrides or {}).items():
        _set_dotted(cfg, key, value)
    return cfg


def parse_cli(argv: Sequence[str], base: str = "train.yaml",
              cfg_dir: Optional[Path] = None) -> Dict[str, Any]:
    """Parse the `with name1 name2 key=value ...` command line."""
    args = list(argv)
    if args and args[0] == "with":
        args = args[1:]
    named: List[str] = []
    overrides: Dict[str, Any] = {}
    for a in args:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = _parse_value(v)
        else:
            named.append(a)
    return load_config(base, named, overrides, cfg_dir)


def dump_config(cfg: Dict[str, Any], path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def nested_namespace(cfg: Any) -> Any:
    """dict -> nested SimpleNamespace."""
    if isinstance(cfg, dict):
        ns = SimpleNamespace()
        for k, v in cfg.items():
            setattr(ns, k, nested_namespace(v))
        return ns
    if isinstance(cfg, list):
        return [nested_namespace(v) for v in cfg]
    return cfg


def namespace_to_dict(ns: Any) -> Any:
    if isinstance(ns, SimpleNamespace):
        return {k: namespace_to_dict(v) for k, v in vars(ns).items()}
    if isinstance(ns, list):
        return [namespace_to_dict(v) for v in ns]
    return ns
