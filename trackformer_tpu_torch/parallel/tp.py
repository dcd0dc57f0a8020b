"""Tensor parallelism over a model group: Megatron's column and row splits.

Counterpart of `trackformer_tpu/parallel/tp.py`. The JAX package writes
`RULES` over flax paths and lets XLA's sharding propagation place the
collectives; here the same rules, in the port's state-dict names, split
the tensors over the ranks of one model group, and the layers call the
two collectives themselves:

  * column-parallel (output features split, whole heads per rank):
    `value_proj`, `sampling_offsets`, `attention_weights`, `linear1`, and
    the q, k and v rows of a packed `in_proj_weight` / `in_proj_bias`
    (each of q, k and v split by heads, not the packed tensor in thirds).
    Their input goes through `enter`: the identity forward, whose backward
    sums the input's gradient over the group (Megatron's f), so that the
    replicated tensors upstream get whole gradients;
  * row-parallel (input features split): `out_proj`, `output_proj`,
    `linear2`; `row_linear` sums the partial products over the group
    (Megatron's g) and adds the replicated bias once;
  * everything else (the trunk, norms, embeddings, heads) replicated.

The MSDA projections are head-major (`(M, L, P, 2)` offsets, `(M, L, P)`
weights, `(M, D)` values), so a contiguous slice of their rows is whole
heads and the MSDA core runs on M / N heads a rank. A dropout inside a
split region draws the mask one process would draw for the full width and
keeps this rank's slice (`Dropout(x, tp=...)`), so that the masks, and the
generator's state after them, are those of one process. Kernel #8 (the
windowed layer in eval mode) takes whole weights: `gathered` rebuilds a
layer's full tensors on every rank before the call.

`shard_model` splits a built model in place and marks its modules;
`split_state` / `gather_state` move a train state's tensors between the
full layout of one process (checkpoints) and this rank's shards.
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from . import dist as pdist

_COLUMN = r"(value_proj|sampling_offsets|attention_weights|linear1)"
_ROW = r"(out_proj|output_proj|linear2)"

# (state-dict key regex, how the tensor splits); first match wins, none:
# replicated
RULES = [
    (re.compile(_COLUMN + r"\.(weight|bias)$"), "column"),
    (re.compile(r"in_proj_(weight|bias)$"), "qkv"),
    (re.compile(_ROW + r"\.weight$"), "row"),
]


def rule_for(key: str) -> Optional[str]:
    """"column", "qkv", "row" or None (replicated) for a state-dict key."""
    for pattern, how in RULES:
        if pattern.search(key):
            return how
    return None


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place in its model group."""
    group: object
    rank: int
    size: int


def shard_of(module: Optional[nn.Module]) -> Optional[Shard]:
    """The `Shard` of a module that `shard_model` split, else None."""
    return getattr(module, "tp", None)


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return pdist.all_reduce(grad.contiguous().clone(), ctx.group), None


class _Leave(torch.autograd.Function):
    """The forward sums over the group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return pdist.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """`x` as the input of a column-parallel region of `module`."""
    tp = shard_of(module)
    return x if tp is None else _Enter.apply(x, tp.group)


def reduce(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """`x` summed over `module`'s group (as is when it is not split)."""
    tp = shard_of(module)
    return x if tp is None else _Leave.apply(x, tp.group)


def row_linear(x: torch.Tensor, lin: nn.Linear,
               rounded: bool = False) -> torch.Tensor:
    """`lin(x)` for a row-parallel `lin`: the partial products summed over
    the group, then the bias. Unsplit, `lin(x)`, or with `rounded` the
    port's `dense` (product, then bias)."""
    tp = shard_of(lin)
    if tp is None:
        return F.linear(x, lin.weight) + lin.bias if rounded else lin(x)
    return _Leave.apply(F.linear(x, lin.weight), tp.group) + lin.bias


def split_tensor(full: torch.Tensor, how: str, rank: int,
                 size: int) -> torch.Tensor:
    """This rank's slice of a full tensor split by `how`."""
    if how == "column":
        return full.chunk(size, 0)[rank]
    if how == "qkv":
        return torch.cat([part.chunk(size, 0)[rank]
                          for part in full.chunk(3, 0)])
    if how == "row":
        return full.chunk(size, 1)[rank]
    raise ValueError(how)


def gather_tensor(local: torch.Tensor, how: str, shard: Shard
                  ) -> torch.Tensor:
    """The full tensor from every rank's slice (each rank writes its slice
    into zeros and the group sums them: exact, and an all-reduce, which
    gloo does on CUDA tensors too)."""
    if how == "row":
        shape = (local.shape[0], local.shape[1] * shard.size)
    else:
        shape = (local.shape[0] * shard.size,) + tuple(local.shape[1:])
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    if how == "qkv":
        n = local.shape[0] // 3
        for i, part in enumerate(full.chunk(3, 0)):
            part.chunk(shard.size, 0)[shard.rank].copy_(
                local[i * n:(i + 1) * n])
    else:
        split_tensor(full, how, shard.rank, shard.size).copy_(local)
    return pdist.all_reduce(full, shard.group)


def _split_param(module: nn.Module, name: str, how: str, shard: Shard):
    p = getattr(module, name)
    p.data = split_tensor(p.data, how, shard.rank, shard.size).clone()


def shard_model(model: nn.Module, layout: pdist.Layout) -> frozenset:
    """Split `model`'s attention and FFN tensors over `layout`'s model
    group, in place, by `RULES`, and mark the modules whose forward then
    calls the collectives -> the split tensors' state-dict keys (also kept
    as `model.tp_sharded`). The model's MSDA and attention modules run on
    their heads / N afterwards."""
    from ..models.attention import MultiHeadAttention
    from ..models.deformable_transformer import MSDeformAttnModule

    if layout.model_size == 1:
        model.tp_sharded = frozenset()
        return model.tp_sharded
    shard = Shard(layout.model_group, layout.model_rank, layout.model_size)
    n = shard.size
    keys = set()
    for prefix, mod in model.named_modules():
        pre = prefix + "." if prefix else ""
        if isinstance(mod, MultiHeadAttention):
            if mod.num_heads % n:
                raise ValueError(f"{prefix}: {mod.num_heads} heads do not "
                                 f"split over tpu.model_parallel {n}")
            _split_param(mod, "in_proj_weight", "qkv", shard)
            _split_param(mod, "in_proj_bias", "qkv", shard)
            _split_param(mod.out_proj, "weight", "row", shard)
            mod.num_heads //= n
            mod.tp = mod.out_proj.tp = shard
            keys |= {pre + "in_proj_weight", pre + "in_proj_bias",
                     pre + "out_proj.weight"}
        elif isinstance(mod, MSDeformAttnModule):
            if mod.n_heads % n:
                raise ValueError(f"{prefix}: {mod.n_heads} heads do not "
                                 f"split over tpu.model_parallel {n}")
            for lin in ("value_proj", "sampling_offsets",
                        "attention_weights"):
                _split_param(getattr(mod, lin), "weight", "column", shard)
                _split_param(getattr(mod, lin), "bias", "column", shard)
                getattr(mod, lin).tp = shard
                keys |= {f"{pre}{lin}.weight", f"{pre}{lin}.bias"}
            _split_param(mod.output_proj, "weight", "row", shard)
            mod.n_heads //= n
            mod.tp = mod.output_proj.tp = shard
            keys.add(pre + "output_proj.weight")
        lin1, lin2 = getattr(mod, "linear1", None), getattr(mod, "linear2",
                                                            None)
        if isinstance(lin1, nn.Linear) and isinstance(lin2, nn.Linear):
            if lin1.out_features % n:
                raise ValueError(f"{prefix}: dim_feedforward "
                                 f"{lin1.out_features} does not split over "
                                 f"tpu.model_parallel {n}")
            _split_param(lin1, "weight", "column", shard)
            _split_param(lin1, "bias", "column", shard)
            _split_param(lin2, "weight", "row", shard)
            lin1.tp = lin2.tp = shard
            keys |= {pre + "linear1.weight", pre + "linear1.bias",
                     pre + "linear2.weight"}
    ruled = {k for k in model.state_dict() if rule_for(k)}
    if ruled != keys:
        raise RuntimeError("tensor-parallel rules and layers disagree on "
                           f"{sorted(ruled ^ keys)}")
    model.tp_sharded = frozenset(keys)
    return model.tp_sharded


def sharded_keys(model: nn.Module) -> frozenset:
    return getattr(model, "tp_sharded", frozenset())


def gathered(module: nn.Module) -> nn.Module:
    """A copy of a split module (e.g. a windowed encoder layer) with its
    full tensors, unmarked, for a call that takes whole weights. Every
    rank of the group calls it."""
    # the copy shares the `Shard`s (a process group does not copy)
    memo = {id(tp): tp for tp in map(shard_of, module.modules()) if tp}
    full = copy.deepcopy(module, memo)
    for name, sub in list(full.named_modules()):
        tp = shard_of(sub)
        if tp is None:
            continue
        for pname, p in list(sub.named_parameters(recurse=False)):
            how = rule_for(f"{name}.{pname}" if name else pname)
            if how is not None:
                p.data = gather_tensor(p.data, how, tp)
        if hasattr(sub, "num_heads"):
            sub.num_heads *= tp.size
        if hasattr(sub, "n_heads"):
            sub.n_heads *= tp.size
        del sub.tp
    return full


def split_state(full: Dict[str, torch.Tensor], sharded: frozenset,
                shard: Shard) -> Dict[str, torch.Tensor]:
    """Full tensors by state-dict key -> this rank's (split keys sliced)."""
    return {k: (split_tensor(v, rule_for(k), shard.rank, shard.size)
                if k in sharded else v) for k, v in full.items()}


def gather_state(state, sharded: frozenset, layout: pdist.Layout):
    """A train state of full tensors (the layout of one process, what a
    checkpoint keeps) from every rank's shards; every rank calls it."""
    from ..engine.train_step import TrainState

    if layout.model_size == 1:
        return state
    shard = Shard(layout.model_group, layout.model_rank, layout.model_size)

    def full(tensors):
        return {k: (gather_tensor(v, rule_for(k), shard) if k in sharded
                    else v) for k, v in tensors.items()}
    return TrainState(params=full(state.params), mu=full(state.mu),
                      nu=full(state.nu), step=state.step)


@torch.no_grad()
def load_full_state(state, full, model: nn.Module, layout: pdist.Layout):
    """Copy a full train state (`gather_state`'s layout, e.g. restored from
    a checkpoint) into this rank's shards of `state` and the model."""
    from ..engine.train_step import train_tensors

    sharded = sharded_keys(model)
    shard = Shard(layout.model_group, layout.model_rank, layout.model_size)
    for name in ("params", "mu", "nu"):
        own = getattr(state, name)
        for k, v in split_state(getattr(full, name), sharded, shard).items():
            own[k].copy_(v)
    for k, t in train_tensors(model).items():
        if t.data_ptr() != state.params[k].data_ptr():
            t.copy_(state.params[k])
    state.step = full.step
    return state
