"""The training step: loss, gradients, global-norm clip, param-group AdamW
with its learning-rate schedule.

Counterpart of `trackformer_tpu/engine/train_step.py`:

  * param groups: the backbone at `lr_backbone`; `reference_points` and
    `sampling_offsets` at `lr * lr_linear_proj_mult`; track-attention
    layers at `lr_track`; everything else at `lr`; the trunk's stem and
    `layer1` and every frozen-BN tensor get no update;
  * AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay times the
    learning rate), MultiStep x0.1 drops at `lr_drop_steps`, optional
    linear warmup;
  * gradients clipped by their global norm BEFORE the group transform. As
    in the JAX package, the norm runs over every tensor of the parameter
    tree, the frozen group included (frozen convolutions and the FrozenBN
    weight, bias and statistics are differentiated like any other leaf and
    only their update is zero), so `grad_norm` and the clip factor are the
    JAX step's.

The model computes in the config's dtype. The train state holds float32
master weights and Adam moments, the model's parameters are their cast
copy, refreshed after every update, and gradients are cast up before the
clip. In float32 master and model are the same tensors.

One function serves detection and two- or three-frame tracking training;
the latter runs the previous frames' forwards, the matches and the
track-query augmentations inside the step.

Over several processes (`layout`, `parallel/dist.py`) the step is one
process's step on the data ranks' concatenated batch: `num_boxes` is the
global count (summed over the data ranks, as the JAX step counts it over
its sharded global batch), divided by the data ranks, whose gradients are
then averaged in one bucketed all-reduce before the clip; the logged
losses are averaged likewise. Under tensor parallelism the global norm
sums the squares of the split tensors over the model group and counts the
replicated ones once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.attention import set_dropout_generator
from ..models.backbone import FrozenBatchNorm2d
from ..models.criterion import CriterionConfig, compute_losses
from ..models.tracking import TrackingConfig, tracking_train_forward
from ..parallel import dist as pdist
from ..parallel import tp as tensor_parallel
from ..utils.config import FlagshipConfig

GROUPS = ("base", "backbone", "linear_proj", "track", "frozen")


def param_label(name: str, lr_backbone_trainable: bool = True) -> str:
    """The optimizer group of a tensor by its state-dict key."""
    if name.startswith("backbone."):
        leaf = name.rsplit(".", 1)[0].rsplit(".", 1)[-1]
        # frozen BN statistics and affine everywhere in the trunk
        # (`downsample.1` is a block's downsample BN)
        if leaf.startswith("bn") or ".downsample.1." in name:
            return "frozen"
        # stem and layer1 frozen
        if ".body.conv1." in name or ".body.layer1." in name:
            return "frozen"
        return "backbone" if lr_backbone_trainable else "frozen"
    if "reference_points" in name or "sampling_offsets" in name:
        return "linear_proj"
    if "track_attention" in name:
        return "track"
    return "base"


def train_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor of the JAX parameter tree by its state-dict key: the
    model's parameters and the FrozenBN buffers."""
    out = dict(model.named_parameters())
    for mod_name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            for buf_name, buf in mod.named_buffers(recurse=False):
                out[f"{mod_name}.{buf_name}"] = buf
    return out


def label_params(model: nn.Module, lr_backbone_trainable: bool = True
                 ) -> Dict[str, str]:
    return {name: param_label(name, lr_backbone_trainable)
            for name in train_tensors(model)}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What `make_optimizer` returns: each tensor's group, each group's
    base learning rate, and the schedule's and AdamW's constants."""
    labels: Dict[str, str]
    group_lr: Dict[str, float]
    weight_decay: float
    clip_max_norm: float
    drop_steps: Tuple[int, ...] = ()
    warmup_steps: int = 0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def lr_scale(self, step: int) -> float:
        """The schedule's factor at update `step` (0-based): x0.1 past each
        drop step, times the linear warmup."""
        scale = 0.1 ** sum(1 for s in self.drop_steps if step >= s)
        if self.warmup_steps:
            scale *= min(1.0, (step + 1) / self.warmup_steps)
        return scale


def make_optimizer(cfg: FlagshipConfig, model: nn.Module,
                   lr_drop_steps=None) -> Optimizer:
    """Param-group AdamW with MultiStep drops and global-norm clipping.
    `cfg` carries lr, lr_backbone, lr_linear_proj_mult, lr_track,
    weight_decay, clip_max_norm and lr_warmup_steps;
    `lr_drop_steps` is one step or a list of steps at which the learning
    rate drops x0.1 (`lr_drop` epochs times the steps per epoch)."""
    if lr_drop_steps is None:
        drops: Tuple[int, ...] = ()
    elif isinstance(lr_drop_steps, (list, tuple)):
        drops = tuple(sorted(int(s) for s in lr_drop_steps))
    else:
        drops = (int(lr_drop_steps),)
    return Optimizer(
        labels=label_params(model, lr_backbone_trainable=cfg.lr_backbone > 0),
        group_lr={"base": cfg.lr, "backbone": cfg.lr_backbone,
                  "linear_proj": cfg.lr * cfg.lr_linear_proj_mult,
                  "track": cfg.lr_track},
        weight_decay=cfg.weight_decay, clip_max_norm=cfg.clip_max_norm,
        drop_steps=drops, warmup_steps=cfg.lr_warmup_steps)


@dataclasses.dataclass
class TrainState:
    """Float32 master weights and Adam moments by state-dict key, and the
    number of updates taken. `params` of the frozen group are the model's
    own tensors (they never change)."""
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer) -> "TrainState":
        params, mu, nu = {}, {}, {}
        for name, t in train_tensors(model).items():
            if optimizer.labels[name] == "frozen" \
                    or t.dtype == torch.float32:
                params[name] = t.detach()
            else:
                params[name] = t.detach().float().clone()
            if optimizer.labels[name] != "frozen":
                mu[name] = torch.zeros_like(params[name])
                nu[name] = torch.zeros_like(params[name])
        return cls(params=params, mu=mu, nu=nu, step=0)


def global_norm(grads: Dict[str, torch.Tensor],
                sharded: frozenset = frozenset(),
                layout: Optional[pdist.Layout] = None) -> torch.Tensor:
    """The global norm of every gradient; `sharded` keys are this rank's
    slices of tensors split over `layout`'s model group."""
    if not sharded:
        return torch.sqrt(sum(g.square().sum() for g in grads.values()))
    split = sum(grads[k].square().sum() for k in sharded)
    split = pdist.all_reduce(split, layout.model_group)
    rest = sum(g.square().sum() for k, g in grads.items()
               if k not in sharded)
    return torch.sqrt(split + rest)


def average_over_data_ranks(grads: Dict[str, torch.Tensor],
                            layout: pdist.Layout) -> None:
    """Average the gradients over the data ranks in place: one all-reduce
    of one flat bucket."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    pdist.all_reduce(flat, layout.data_group)
    flat /= layout.data_size
    offset = 0
    for g in grads.values():
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def apply_update(model_tensors: Dict[str, torch.Tensor], state: TrainState,
                 grads: Dict[str, torch.Tensor], opt: Optimizer,
                 norm: torch.Tensor) -> torch.Tensor:
    """Clip `grads` (float32, every tensor of the tree) by their global
    norm `norm` (`global_norm`), take one AdamW update of the master
    weights group by group, and copy them into the model. Returns the norm
    before the clip."""
    # (g / norm) * max_norm where the norm exceeds max_norm, else g
    one = torch.ones_like(norm)
    trigger = norm < opt.clip_max_norm
    div = torch.where(trigger, one, norm)
    mul = torch.where(trigger, one, opt.clip_max_norm * one)
    count = state.step + 1
    scale = opt.lr_scale(state.step)
    bc1 = 1.0 - opt.b1 ** count
    bc2 = 1.0 - opt.b2 ** count
    for name, mu in state.mu.items():
        lr = opt.group_lr[opt.labels[name]] * scale
        g = grads[name] / div * mul
        nu = state.nu[name]
        mu.mul_(opt.b1).add_(g, alpha=1.0 - opt.b1)
        nu.mul_(opt.b2).addcmul_(g, g, value=1.0 - opt.b2)
        p = state.params[name]
        update = (mu / bc1) / ((nu / bc2).sqrt() + opt.eps) \
            + opt.weight_decay * p
        p.add_(update, alpha=-lr)
        target = model_tensors[name]
        if target.data_ptr() != p.data_ptr():
            target.copy_(p)
    state.step = count
    return norm


def make_train_step(model: nn.Module, criterion_cfg: CriterionConfig,
                    optimizer: Optimizer,
                    tracking_cfg: Optional[TrackingConfig] = None,
                    tracking: bool = False,
                    timings: Optional[Callable[[str], None]] = None,
                    return_grads: bool = False,
                    prev_prev: bool = False,
                    layout: Optional[pdist.Layout] = None) -> Callable:
    """Returns train_step(state, pack, generator, forced=None) ->
    (state, metrics). `pack` holds `batch` (FrameBatch) and `targets`
    (Targets) and, in tracking mode, `prev_batch` and `prev_targets`; with
    `prev_prev` (`track_prev_prev_frame`) also `prev_prev_batch` and
    `prev_prev_targets`, and the step trains on three frames.
    `generator` (on the model's device) drives dropout and the track-query
    draws; `forced` pins the draws (tests). `metrics` holds `loss`, every
    loss key and `grad_norm` as 0-d tensors; with `return_grads` also,
    under `_grads`, the float32 gradients by state-dict key (keys with a
    leading underscore are not for logging). The state is updated in place
    and returned.
    `timings(tag)`, if given, is called after each stage (forward_prev,
    match_augment, forward, criterion, backward, grad_allreduce over
    several data ranks, optimizer). `layout` (default: one process) places
    the step over several processes (module docstring); the model is
    already split over its model group (`parallel.tp.shard_model`)."""
    weight_dict = criterion_cfg.weight_dict
    layout = layout or pdist.Layout()
    sharded = tensor_parallel.sharded_keys(model)
    tensors = train_tensors(model)
    names = list(tensors)
    mark = timings or (lambda tag: None)

    def apply_fn(batch, targets, prev_features):
        return model(batch, targets, prev_features)

    def train_step(state: TrainState, pack: Dict,
                   generator: Optional[torch.Generator] = None,
                   forced: Optional[dict] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        set_dropout_generator(model, generator)
        for t in tensors.values():
            t.requires_grad_(True)
        try:
            if tracking:
                out, targets = tracking_train_forward(
                    apply_fn, pack["batch"], pack["targets"],
                    pack["prev_batch"], pack["prev_targets"], generator,
                    tracking_cfg,
                    prev_prev_batch=(pack["prev_prev_batch"] if prev_prev
                                     else None),
                    prev_prev_targets=(pack["prev_prev_targets"]
                                       if prev_prev else None),
                    forced=forced, mark=mark)
            else:
                out, targets, _, _, _ = apply_fn(pack["batch"],
                                                 pack["targets"], None)
            mark("forward")
            num_boxes = targets.valid.sum().float()
            if layout.data_size > 1:
                num_boxes = pdist.all_reduce(
                    num_boxes, layout.data_group).clamp(min=1.0) \
                    / layout.data_size
            else:
                num_boxes = num_boxes.clamp(min=1.0)
            losses = compute_losses(out, targets, criterion_cfg, num_boxes)
            total = sum(losses[k] * w for k, w in weight_dict.items()
                        if k in losses)
            mark("criterion")
            grads = torch.autograd.grad(total, [tensors[n] for n in names],
                                        allow_unused=True)
            mark("backward")
        finally:
            for name, t in tensors.items():
                if not isinstance(t, nn.Parameter):
                    t.requires_grad_(False)
        grads = {n: (torch.zeros(tensors[n].shape, device=total.device)
                     if g is None else g.float())
                 for n, g in zip(names, grads)}
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        if layout.data_size > 1:
            average_over_data_ranks(grads, layout)
            keys = list(metrics)
            mean = pdist.all_reduce(torch.stack(
                [metrics[k].float() for k in keys]), layout.data_group)
            metrics = dict(zip(keys, mean / layout.data_size))
            mark("grad_allreduce")
        norm = apply_update(tensors, state, grads, optimizer,
                            norm=global_norm(grads, sharded, layout))
        mark("optimizer")
        metrics["grad_norm"] = norm
        if return_grads:
            metrics["_grads"] = grads
        return state, metrics

    return train_step
