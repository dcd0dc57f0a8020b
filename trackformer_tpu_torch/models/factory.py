"""Model factory: the flagship configuration -> (model, postprocessor),
or for training (model, criterion config, postprocessor, tracking config).

Counterpart of the part of `trackformer_tpu/models/factory.py` that builds
the tracking model and its training companions. Only the configurations this port supports are
accepted: the flagship with the exact-MSDA encoder, or in the TPU-fast
mode (`FlagshipConfig.tpu_fast()`). `init_params` draws every weight from
an explicit `torch.Generator` with the JAX package's initializers (flax
defaults: lecun-normal kernels, zero biases; plus the model's own special
inits), so a seed gives the same weights on every run of one device type.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..utils.config import FlagshipConfig
from .attention import MultiHeadAttention
from .backbone import FrozenBatchNorm2d
from .criterion import CriterionConfig
from .deformable_detr import DeformableDETR, InputProj
from .deformable_transformer import MSDeformAttnModule
from .matcher import MatcherConfig
from .postprocess import postprocess_sigmoid
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


# the two encoder modes ported: exact MSDA over both frames, and the
# TPU-fast windowed encoder over the current frame with the cached memory
_ENCODER_MODES = {("msda", False), ("windowed", True)}


def _check_supported(cfg: FlagshipConfig) -> None:
    wanted = dict(deformable=True, with_box_refine=True, two_stage=False,
                  masks=False, focal_loss=True, multi_frame_attention=True,
                  multi_frame_encoding=True,
                  multi_frame_attention_separate_encoder=True,
                  merge_frame_features=False, decoder_attention="msda",
                  scan_layers=False, position_embedding="sine",
                  num_feature_levels=4)
    bad = {k: getattr(cfg, k) for k, v in wanted.items()
           if getattr(cfg, k) != v}
    mode = (cfg.encoder_attention, cfg.cached_prev_memory)
    if mode not in _ENCODER_MODES:
        bad.update(encoder_attention=mode[0], cached_prev_memory=mode[1])
    if bad:
        raise NotImplementedError(f"not ported yet: {bad}")


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
def init_params(model: DeformableDETR, generator: torch.Generator) -> None:
    """Draw every parameter and buffer of `model` from `generator`."""
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
    model.query_embed.weight.normal_(0.0, 1.0, generator=g)
    xavier(model.transformer.reference_points.weight)
    focal_bias = -math.log((1 - 0.01) / 0.01)
    for cls in model.class_embed:
        cls.bias.fill_(focal_bias)
    for box in model.bbox_embed:
        box.layers[-1].weight.zero_()
        box.layers[-1].bias.copy_(torch.tensor([0.0, 0.0, -2.0, -2.0]))


def train_configs(cfg: FlagshipConfig
                  ) -> Tuple[CriterionConfig, TrackingConfig]:
    """The criterion and track-query configs the JAX factory derives from
    the same fields: matcher costs, the loss weights with their `_i` keys
    for the auxiliary decoder outputs, and the augmentation
    probabilities."""
    matcher = MatcherConfig(
        cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
        cost_giou=cfg.set_cost_giou, focal_loss=cfg.focal_loss,
        focal_alpha=cfg.focal_alpha, focal_gamma=cfg.focal_gamma)
    weight_dict = {"loss_ce": cfg.cls_loss_coef,
                   "loss_bbox": cfg.bbox_loss_coef,
                   "loss_giou": cfg.giou_loss_coef}
    if cfg.aux_loss:
        aux = {}
        for i in range(cfg.dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in weight_dict.items()})
        weight_dict.update(aux)
    criterion = CriterionConfig(
        num_classes=DATASET_NUM_CLASSES[cfg.dataset], matcher=matcher,
        weight_dict=weight_dict, eos_coef=cfg.eos_coef,
        focal_loss=cfg.focal_loss, focal_alpha=cfg.focal_alpha,
        focal_gamma=cfg.focal_gamma, tracking=cfg.tracking,
        track_query_false_positive_eos_weight=(
            cfg.track_query_false_positive_eos_weight))
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
    CPU) in the config's compute dtype -> (model, postprocess). With a
    generator the weights are drawn from it; without one they are left
    uninitialized for `load_state_dict`. FrozenBN statistics stay float32,
    as the JAX package keeps its parameters float32 and casts them at use.

    With `train` the model carries the config's dropout and is returned in
    training mode, as (model, criterion config, postprocess, tracking
    config), the JAX factory's tuple; the float32 master weights that AdamW
    updates live in the train state (`engine/train_step.py`)."""
    _check_supported(cfg)
    if train and cfg.cached_prev_memory:
        raise NotImplementedError("training the TPU-fast mode is not ported "
                                  "yet: its window-layer kernel has no "
                                  "backward")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' "
                           "to build on the CPU")
    head_classes = DATASET_NUM_CLASSES[cfg.dataset] - 1  # focal: no bg slot
    with torch.device("meta"):
        model = DeformableDETR(
            head_classes, num_queries=cfg.num_queries,
            hidden_dim=cfg.hidden_dim, nheads=cfg.nheads,
            enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward,
            num_feature_levels=cfg.num_feature_levels,
            dec_n_points=cfg.dec_n_points, enc_n_points=cfg.enc_n_points,
            backbone_name=cfg.backbone, dilation=cfg.dilation,
            aux_loss=cfg.aux_loss,
            encoder_window=(cfg.encoder_window
                            if cfg.encoder_attention == "windowed" else None),
            dropout=cfg.dropout if train else 0.0)
    model.to_empty(device=device)
    if generator is not None:
        init_params(model, generator)
    model.to(_DTYPES[cfg.compute_dtype])
    for mod in model.modules():
        if isinstance(mod, FrozenBatchNorm2d):
            mod.float()
    if train:
        model.train()
        criterion_cfg, tracking_cfg = train_configs(cfg)
        return model, criterion_cfg, postprocess_sigmoid, tracking_cfg
    model.eval()
    return model, postprocess_sigmoid
