"""Model factory: a config -> (model, postprocess), or for training
(model, criterion config, postprocess, tracking config).

Counterpart of `trackformer_tpu/models/factory.py`: the dataset's class
count, the four model classes ({DETR, DeformableDETR} x {plain, Segm}),
the criterion's loss weights (with the mask losses', the auxiliary
outputs' `_i` and the two-stage proposals' `_enc` keys) and the
postprocessors (softmax for a plain-CE head, sigmoid for a focal one,
`postprocess_segm` for masks, and on `coco_panoptic` with masks
`postprocess_panoptic`, things being the categories up to 90). The
Deformable DETR family is taken
single-frame or multi-frame (3-D or 2-D positions, a separate or a joint
encoder, merged frame features), at 3 or more feature levels over a
ResNet-50 or -101 with or without DC5, with or without box refinement and
two-stage, its encoder exact MSDA or windowed (window side 8 or 16), with
the cached previous memory on the multi-frame separate-encoder model
(either encoder; `FlagshipConfig.tpu_fast()` is the windowed one), its
decoder's cross-attention MSDA or dense; `tpu.scan_layers` builds the same
model unrolled. `tpu.remat` recomputes, in a training step's backward,
each exact-MSDA encoder layer's activations and, on a `tpu.scan_layers`
model, each decoder layer's (the layers the JAX package wraps in
`nn.remat`; its decoder is a scan only there). Vanilla DETR is taken
with post- or pre-norm layers and track attention. Positions are sine:
`position_embedding: learned` builds the same model, as in the JAX
package, which builds its models with sine positions whatever the flag.
What is not ported, or what the JAX package cannot run, raises
(`_check_supported`). `init_params` draws every weight from an
explicit `torch.Generator` with the JAX package's initializers (flax
defaults: lecun-normal kernels, zero biases; plus each model's own special
inits), so a seed gives the same weights on every run of one device type.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.window_attn import WINDOW_SIDES
from ..utils.config import FlagshipConfig
from .attention import MultiHeadAttention
from .backbone import FrozenBatchNorm2d
from .criterion import CriterionConfig
from .deformable_detr import DeformableDETR, InputProj
from .deformable_transformer import MSDeformAttnModule
from .detr import DETR
from .matcher import MatcherConfig
from .panoptic import postprocess_panoptic
from .postprocess import postprocess_sigmoid, postprocess_softmax
from .segmentation import DeformableDETRSegm, DETRSegm, postprocess_segm
from .tracking import TrackingConfig

DATASET_NUM_CLASSES = {
    "coco": 91,
    "coco_panoptic": 250,
    "coco_person": 20,
    "mot": 20,
    "mot_crowdhuman": 20,
    "crowdhuman": 20,
    "mot_coco_person": 20,
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cached_mode(cfg: FlagshipConfig) -> bool:
    """Whether `tpu.cached_prev_memory` takes effect: on a multi-frame
    model with a separate encoder and unmerged frames (JAX
    `_cached_mode`)."""
    return bool(cfg.cached_prev_memory and cfg.multi_frame_attention
                and cfg.multi_frame_attention_separate_encoder
                and not cfg.merge_frame_features)


def _check_supported(cfg: FlagshipConfig) -> None:
    """Raise `NotImplementedError` naming the ROADMAP item for what the
    port has not taken yet: on the Deformable DETR family, masks on the
    cached memory (which appends the encoded memory to the feature pairs,
    shifting the levels the mask head reads, in the JAX package as well),
    and a window side kernel #8 is not instantiated at; raise `ValueError`
    for what the JAX package cannot run (ROADMAP Queue 3), a Deformable
    DETR of fewer than 3 feature levels, and for an attention knob neither
    package knows."""
    if not cfg.deformable:
        return
    if cfg.num_feature_levels < 3:
        raise ValueError(
            f"num_feature_levels {cfg.num_feature_levels}: the JAX package "
            f"raises IndexError here (DeformableDETR.__call__ passes the "
            f"last three backbone maps to _project_frame, and setup builds "
            f"only min(3, L) input projections); use 3 or more (ROADMAP "
            f"Queue 3)")
    if cfg.encoder_attention not in ("msda", "windowed"):
        raise ValueError(f"tpu.encoder_attention {cfg.encoder_attention!r}")
    if cfg.decoder_attention not in ("msda", "dense"):
        raise ValueError(f"tpu.decoder_attention {cfg.decoder_attention!r}")
    if (cfg.encoder_attention == "windowed"
            and cfg.encoder_window not in WINDOW_SIDES):
        raise NotImplementedError(
            f"tpu.encoder_window {cfg.encoder_window}: kernel #8 is "
            f"instantiated at window sides {WINDOW_SIDES}")
    if cfg.masks and cached_mode(cfg):
        raise NotImplementedError(
            "masks with tpu.cached_prev_memory are not ported (ROADMAP "
            "Queue 1, item 9): the cached mode shifts the levels the mask "
            "head reads, in the JAX package too (Queue 3)")


# `position_embedding: learned` said once a process
_SAID = set()


def msda_offset_bias(n_heads: int, n_levels: int, n_points: int
                     ) -> np.ndarray:
    """Directional sampling-offset bias: 8 compass directions, point p
    scaled by p + 1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter and buffer of `model` (a DETR or Deformable
    DETR, with or without masks) from `generator`."""
    g = generator

    def lecun(w: torch.Tensor) -> None:
        fan_in = w[0].numel()
        w.normal_(0.0, math.sqrt(1.0 / fan_in), generator=g)

    def xavier(w: torch.Tensor) -> None:
        fan_in, fan_out = w[0].numel(), w.shape[0] * w[0, 0].numel()
        a = math.sqrt(6.0 / (fan_in + fan_out))
        w.uniform_(-a, a, generator=g)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            lecun(mod.weight)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, MultiHeadAttention):
            for w in mod.in_proj_weight.chunk(3):
                lecun(w)
            mod.in_proj_bias.zero_()
    if not isinstance(model, DeformableDETR):
        # vanilla DETR: flax defaults but for the unit-normal queries
        model.query_embed.weight.normal_(0.0, 1.0, generator=g)
        return
    for mod in model.modules():
        if isinstance(mod, InputProj):
            xavier(mod[0].weight)
        elif isinstance(mod, MSDeformAttnModule):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(torch.from_numpy(
                msda_offset_bias(mod.n_heads, mod.n_levels, mod.n_points)))
            mod.attention_weights.weight.zero_()
    model.transformer.level_embed.normal_(0.0, 1.0, generator=g)
    if model.cached_memory:
        model.transformer.frame_embed.normal_(0.0, 1.0, generator=g)
    if not model.two_stage:
        model.query_embed.weight.normal_(0.0, 1.0, generator=g)
        xavier(model.transformer.reference_points.weight)
    focal_bias = -math.log((1 - 0.01) / 0.01)
    for cls in model.class_embed:
        cls.bias.fill_(focal_bias)
    # the box heads' last bias: w, h at -2 (0 for two-stage, whose
    # proposals carry the size)
    wh = 0.0 if model.two_stage else -2.0
    for box in model.bbox_embed:
        box.layers[-1].weight.zero_()
        box.layers[-1].bias.copy_(torch.tensor([0.0, 0.0, wh, wh]))


def train_configs(cfg: FlagshipConfig
                  ) -> Tuple[CriterionConfig, TrackingConfig]:
    """The criterion and track-query configs the JAX factory derives from
    the same fields: matcher costs, the loss weights (with the mask and
    dice weights and the `masks` loss on a masks model) with their `_i`
    keys for the auxiliary decoder outputs, and the augmentation
    probabilities."""
    matcher = MatcherConfig(
        cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
        cost_giou=cfg.set_cost_giou, focal_loss=cfg.focal_loss,
        focal_alpha=cfg.focal_alpha, focal_gamma=cfg.focal_gamma)
    weight_dict = {"loss_ce": cfg.cls_loss_coef,
                   "loss_bbox": cfg.bbox_loss_coef,
                   "loss_giou": cfg.giou_loss_coef}
    if cfg.masks:
        weight_dict.update(loss_mask=cfg.mask_loss_coef,
                           loss_dice=cfg.dice_loss_coef)
    if cfg.aux_loss:
        aux = {}
        for i in range(cfg.dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in weight_dict.items()})
        if cfg.two_stage:
            aux.update({f"{k}_enc": v for k, v in weight_dict.items()})
        weight_dict.update(aux)
    criterion = CriterionConfig(
        num_classes=DATASET_NUM_CLASSES[cfg.dataset], matcher=matcher,
        weight_dict=weight_dict, eos_coef=cfg.eos_coef,
        focal_loss=cfg.focal_loss, focal_alpha=cfg.focal_alpha,
        focal_gamma=cfg.focal_gamma, tracking=cfg.tracking,
        track_query_false_positive_eos_weight=(
            cfg.track_query_false_positive_eos_weight),
        losses=("labels", "boxes", "cardinality")
        + (("masks",) if cfg.masks else ()))
    tracking = TrackingConfig(
        false_positive_prob=cfg.track_query_false_positive_prob,
        false_negative_prob=cfg.track_query_false_negative_prob,
        backprop_prev_frame=cfg.track_backprop_prev_frame, matcher=matcher)
    return criterion, tracking


def build_model(cfg: FlagshipConfig,
                device: torch.device | str = torch.device("cuda"),
                generator: torch.Generator | None = None,
                train: bool = False):
    """Build the model on `device` (the card unless the caller asks for the
    CPU) in the config's compute dtype -> (model, postprocess): `DETR`,
    `DeformableDETR` or, with `masks`, `DETRSegm` / `DeformableDETRSegm`;
    `postprocess` is the box postprocessor, softmax for a plain-CE head
    and sigmoid for a focal one (`postprocessors` adds `segm`). With a
    generator the weights are drawn from it; without one they are left
    uninitialized for `load_state_dict`. FrozenBN statistics stay float32,
    as the JAX package keeps its parameters float32 and casts them at use.

    With `train` the model carries the config's dropout and is returned in
    training mode, as (model, criterion config, postprocess, tracking
    config), the JAX factory's tuple; the float32 master weights that AdamW
    updates live in the train state (`engine/train_step.py`). In the
    windowed encoder a training call runs its module path and an eval-mode
    call kernel #8 (`models/windowed_encoder.py`). A `tpu.scan_layers`
    config builds the unrolled model (the same math); its checkpoints load
    through `utils/checkpoint.py:bridge_scan_layout`."""
    _check_supported(cfg)
    if cfg.position_embedding == "learned" and "learned" not in _SAID:
        _SAID.add("learned")
        print("position_embedding: learned has no effect; the model takes "
              "sine positions, as the JAX package's models do")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' "
                           "to build on the CPU")
    # a focal-loss head has no no-object slot
    head_classes = DATASET_NUM_CLASSES[cfg.dataset] - int(cfg.focal_loss)
    common = dict(num_queries=cfg.num_queries, hidden_dim=cfg.hidden_dim,
                  nheads=cfg.nheads, enc_layers=cfg.enc_layers,
                  dec_layers=cfg.dec_layers,
                  dim_feedforward=cfg.dim_feedforward,
                  backbone_name=cfg.backbone, dilation=cfg.dilation,
                  aux_loss=cfg.aux_loss,
                  dropout=cfg.dropout if train else 0.0)
    with torch.device("meta"):
        if cfg.deformable:
            cls = DeformableDETRSegm if cfg.masks else DeformableDETR
            model = cls(
                head_classes, **common,
                num_feature_levels=cfg.num_feature_levels,
                dec_n_points=cfg.dec_n_points, enc_n_points=cfg.enc_n_points,
                encoder_window=(cfg.encoder_window
                                if cfg.encoder_attention == "windowed"
                                else None),
                multi_frame=cfg.multi_frame_attention,
                multi_frame_encoding=cfg.multi_frame_encoding,
                separate_encoder=cfg.multi_frame_attention_separate_encoder,
                cached_memory=cfg.cached_prev_memory,
                with_box_refine=cfg.with_box_refine,
                two_stage=cfg.two_stage,
                merge_frame_features=cfg.merge_frame_features,
                decoder_attention=cfg.decoder_attention,
                remat=cfg.remat,
                remat_decoder=cfg.remat and cfg.scan_layers)
        else:
            cls = DETRSegm if cfg.masks else DETR
            model = cls(head_classes, **common, pre_norm=cfg.pre_norm,
                        track_attention=cfg.track_attention)
    model.to_empty(device=device)
    if generator is not None:
        init_params(model, generator)
    model.to(_DTYPES[cfg.compute_dtype])
    for mod in model.modules():
        if isinstance(mod, FrozenBatchNorm2d):
            mod.float()
    postprocess = postprocessors(cfg)["bbox"]
    if train:
        model.train()
        criterion_cfg, tracking_cfg = train_configs(cfg)
        return model, criterion_cfg, postprocess, tracking_cfg
    model.eval()
    return model, postprocess


def postprocessors(cfg: FlagshipConfig) -> Dict:
    """The JAX factory's postprocessor dict: `bbox`, `segm` for a masks
    model, and `panoptic` for one on `coco_panoptic` (threshold 0.85,
    things the categories up to 90)."""
    out = {"bbox": (postprocess_sigmoid if cfg.focal_loss
                    else postprocess_softmax)}
    if cfg.masks:
        out["segm"] = postprocess_segm
        if cfg.dataset == "coco_panoptic":
            is_thing_map = {i: i <= 90
                            for i in range(DATASET_NUM_CLASSES[cfg.dataset])}
            out["panoptic"] = functools.partial(
                postprocess_panoptic, is_thing_map=is_thing_map,
                threshold=0.85)
    return out
