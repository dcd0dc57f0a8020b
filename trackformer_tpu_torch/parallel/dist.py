"""Process groups over several processes, one per rank.

Counterpart of `trackformer_tpu/parallel/mesh.py` and of the rank discovery
in `trackformer_tpu/cli/submit.py`. The idiom is PyTorch's own: one process
per rank, started by `torchrun` (or any launcher that sets the variables
below), and `torch.distributed` collectives between them.

  * `init_process_group` reads torchrun's `RANK` / `WORLD_SIZE` /
    `LOCAL_RANK` / `MASTER_ADDR` / `MASTER_PORT`, or the JAX launcher's
    `COORDINATOR_ADDRESS` / `NUM_PROCESSES` / `PROCESS_ID`, and picks the
    backend: NCCL when every rank of the machine has a card of its own,
    gloo when more ranks than cards share them (NCCL refuses two ranks on
    one device; gloo reduces CUDA tensors through the host) and on the
    CPU. The choice is printed. A CUDA device asked for where there is
    none raises.
  * `make_layout(model_parallel)` splits the ranks into data x model
    groups as the JAX package's ("data", "model") mesh does: rank r is
    data rank r // N and model rank r % N; `layout()` returns the current
    one (a single process: one of each).
  * `all_gather_objects` gathers picklable objects of different sizes;
    `shard_batch` cuts a host batch into a rank's share, where the JAX
    package places it on the mesh's "data" axis.

`all_reduce` is the one collective of the training step and the tensor
parallel layers; with `COLLECTIVE_TIMING` on it also adds its wall time
(synchronised around the call) to `COLLECTIVE_SECONDS`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# set to add each all-reduce's wall time to COLLECTIVE_SECONDS (a probe of
# the collectives' share of a step; off by default: it synchronises)
COLLECTIVE_TIMING = False
COLLECTIVE_SECONDS = [0.0]


@dataclasses.dataclass(frozen=True)
class LaunchEnv:
    """What the launcher told this process."""
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    init_method: str


def launch_env(environ=None) -> Optional[LaunchEnv]:
    """The launch variables of this process, or None when nothing launched
    it over several processes (no `RANK` and no `COORDINATOR_ADDRESS`)."""
    env = os.environ if environ is None else environ
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        rank = int(env["RANK"])
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "29500")
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        return LaunchEnv(rank, world, local_rank, local_world,
                         f"tcp://{addr}:{port}")
    if "COORDINATOR_ADDRESS" in env:
        world = int(env["NUM_PROCESSES"])
        rank = int(env["PROCESS_ID"])
        return LaunchEnv(rank, world, rank, world,
                         f"tcp://{env['COORDINATOR_ADDRESS']}")
    return None


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: int) -> str:
    """NCCL when each of the machine's ranks has a card of its own, else
    gloo (ranks sharing a card, or the CPU)."""
    if device_type != "cuda":
        return "gloo"
    if n_cards < 1:
        raise RuntimeError("no CUDA device, and one was asked for; pass "
                           "device='cpu' to run over gloo on the CPU")
    return "nccl" if local_world_size <= n_cards else "gloo"


def init_process_group(device="cuda", environ=None) -> torch.device:
    """Join the process group the environment describes (if it describes
    one and it is not joined yet) -> this rank's device: `cuda:<local rank
    modulo the cards>` or the CPU."""
    device = torch.device(device)
    launch = launch_env(environ)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda" and n_cards < 1:
        raise RuntimeError("no CUDA device, and one was asked for; pass "
                           "device='cpu' to run on the CPU")
    if launch is None:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", launch.local_rank % n_cards)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = choose_backend(device.type, launch.local_world_size, n_cards)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=launch.init_method,
                            rank=launch.rank, world_size=launch.world_size,
                            **kwargs)
    reason = ("a card per rank" if backend == "nccl" else
              "the CPU" if device.type != "cuda" else
              f"{launch.local_world_size} ranks share {n_cards} card(s)")
    print(f"process group: rank {launch.rank}/{launch.world_size}, backend "
          f"{backend} ({reason}), device {device}", flush=True)
    return device


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


@dataclasses.dataclass(frozen=True)
class Layout:
    """The ranks as a (data, model) grid: `data_group` joins the ranks of
    one model rank (the gradients' average), `model_group` the ranks of
    one data rank (the tensor-parallel layers). A group is None where it
    holds one rank."""
    rank: int = 0
    world_size: int = 1
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size


_LAYOUT: Optional[Layout] = None


def make_layout(model_parallel: int = 1) -> Layout:
    """Split the initialised process group into data x model groups (every
    rank calls this, with the same `model_parallel`) and make it the
    current layout."""
    global _LAYOUT
    world, me = world_size(), rank()
    if world % model_parallel:
        raise ValueError(f"tpu.model_parallel {model_parallel} does not "
                         f"divide the {world} processes")
    n_data = world // model_parallel
    data_group = model_group = None
    if world > 1:
        # every rank creates every group, in the same order
        for d in range(n_data):
            ranks = list(range(d * model_parallel, (d + 1) * model_parallel))
            group = dist.new_group(ranks) if model_parallel > 1 else None
            if me in ranks:
                model_group = group
        for m in range(model_parallel):
            ranks = list(range(m, world, model_parallel))
            group = dist.new_group(ranks) if n_data > 1 else None
            if me in ranks:
                data_group = group
    _LAYOUT = Layout(me, world, model_parallel, data_group, model_group)
    return _LAYOUT


def layout() -> Layout:
    """The layout of `make_layout`, or every process a data rank."""
    if _LAYOUT is not None and _LAYOUT.world_size == world_size():
        return _LAYOUT
    if world_size() > 1:
        return Layout(rank(), world_size(), 1, dist.group.WORLD, None)
    return Layout()


def reset_layout() -> None:
    global _LAYOUT
    _LAYOUT = None


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` in place over `group` (every rank when None) -> `t`."""
    if not COLLECTIVE_TIMING:
        dist.all_reduce(t, group=group)
        return t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    COLLECTIVE_SECONDS[0] += time.perf_counter() - t0
    return t


def all_gather_objects(obj, group=None) -> List[Any]:
    """`obj` of every rank of `group` (every process when None), in rank
    order, on every rank: objects of different sizes and structures, as the
    JAX package's `all_gather_objects` (pickled, padded to the largest and
    gathered). One process: [obj]."""
    if not is_distributed() or dist.get_world_size(group) <= 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def shard_batch(tree, index: int, count: int):
    """The `index`-th of `count` equal contiguous blocks of every tensor's
    and array's leading axis in `tree` (dicts, lists, tuples and
    dataclasses of them; None and scalars as they are): a rank's share of a
    global batch, the block the JAX package's "data" axis places on it."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        n = tree.shape[0]
        if n % count:
            raise ValueError(f"a batch of {n} does not split over {count}")
        step = n // count
        return tree[index * step:(index + 1) * step]
    if isinstance(tree, dict):
        return {k: shard_batch(v, index, count) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, index, count) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: shard_batch(getattr(tree, f.name), index, count)
            for f in dataclasses.fields(tree)})
    return tree
