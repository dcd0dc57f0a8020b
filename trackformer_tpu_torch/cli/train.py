"""Training CLI.

Counterpart of `trackformer_tpu/cli/train.py`: seeding, the model with its
criterion and postprocess, both datasets and the batch loader (weighted
sampling, a background prefetch thread), the shape-adaptive warm start
(`resume`), the param-group optimizer with its learning-rate drop, the
train state and its checkpoints (`resume_optim` continues from the epoch
after the last saved one), `eval_only` / `eval_train`, the epoch loop with
a validation every `val_interval` epochs (box AP, and MOTA / IDF1 of the
in-process tracking eval), the best checkpoints by AP, AP50, MOTA and
IDF1, and the resolved config dumped into `output_dir`. A mask model
(`masks`, e.g. `with mots20`) loads mask targets, takes its mask head's
weights from `load_mask_head_from_model` (an `.npz` in the JAX layout:
every `mask_head` / `bbox_attention` tensor of matching shape) and is
evaluated on masks too (`segm`). `freeze_detr` has no effect, as in the
JAX package, which declares it and reads it nowhere.

Usage: python -m trackformer_tpu_torch.cli.train with [named_cfgs...] k=v ...

The model trains on the card unless the caller of `main` passes
`device="cpu"`. `track_prev_prev_frame` trains on three frames and
`track_backprop_prev_frame` through the previous frames; `tpu.remat`
(on in train.yaml) recomputes the exact encoder's layers in the backward.
On `dataset=coco_panoptic` with masks the evaluation adds PQ, SQ and RQ
(`PQ_all`, `SQ_all`, `RQ_all`), its PNGs under `<output_dir>/panoptic_eval`.

Over several processes (one per rank, started by `torchrun` or
`cli/submit.py`; `parallel/dist.py` joins the group from the environment)
`batch_size` is per process, as in the JAX package with one device per
process: each data rank loads its share of the epoch's order (`Loader`'s
`process_index` / `process_count`), seeds numpy with `seed` + its data
rank, and the train step averages the gradients over the data ranks. With
`tpu.model_parallel: N` the ranks form data x model groups (rank r is data
rank r // N) and the attention and FFN tensors are split over each model
group before the optimizer is built (`parallel/tp.py`), so AdamW's moments
are per shard. Only rank 0 writes `config.yaml`, the checkpoints and the
visualizer's files; checkpoints keep the layout of one process (gathered
before saving, split after restoring), so a run resumes at another
`tpu.model_parallel`.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np


# the name of the `Loader`'s prefetch thread
LOADER_THREAD = "trackformer-loader"


class Loader:
    """Host-side batch loader: the dataset's samples in a shuffled, or by
    `weights` sampled, order drawn from `seed + epoch`, collated `batch_size`
    at a time, and prepared `prefetch` batches ahead by a background
    thread (0: in the caller's thread). The samples are drawn in order in
    one thread, so that the datasets' draws from the global numpy RNG come
    in the order of the samples. An error in the thread is raised in the
    consumer. Over several processes each takes every `process_count`-th
    sample of the order from its `process_index` on, as the JAX `Loader`
    does."""

    def __init__(self, dataset, batch_size: int, collate, shuffle: bool,
                 weights=None, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.weights = weights
        self.seed = seed
        self.epoch = 0
        self.pi, self.pc = process_index, process_count
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset) // self.pc
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        n = len(self.dataset)
        if self.weights is not None:
            w = np.asarray(self.weights, np.float64)
            order = rng.choice(n, size=n, replace=True, p=w / w.sum())
        elif self.shuffle:
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        order = order[self.pi::self.pc]
        self.epoch += 1

        def gen():
            batch = []
            for idx in order:
                batch.append(self.dataset[int(idx)])
                if len(batch) == self.batch_size:
                    yield self.collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate(batch)

        if not self.prefetch:
            yield from gen()
            return
        q = queue.Queue(maxsize=self.prefetch)
        done, closed, failed = object(), threading.Event(), []

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in gen():
                    if not put(item):
                        return
            except BaseException as e:  # handed to the consumer
                failed.append(e)
            put(done)

        t = threading.Thread(target=worker, daemon=True,
                             name=LOADER_THREAD)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
            if failed:
                raise failed[0]
        finally:
            # the consumer stopped (or the epoch ended): stop the thread
            closed.set()
            t.join()


def image_buckets(tpu_cfg: dict, img_cfg: dict):
    """(`tpu.image_buckets` as (h, w) pairs, the fallback bucket or None).
    The training crop can leave a frame taller than wide, which
    `RandomResize` then takes to a long side of up to
    `img_transform.max_size` (ROADMAP Queue 3). When no configured bucket
    holds a `max_size` x `max_size` frame, a square bucket of `max_size`
    rounded up to 64 (1344 x 1344 for 1333) takes the batches that no
    configured bucket holds (`builder.bucket_for`); every other batch keeps
    its bucket. Prints one line when it adds the bucket."""
    buckets = [tuple(b) for b in tpu_cfg.get(
        "image_buckets", [[608, 1088], [800, 1344], [1088, 1920]])]
    side = int(img_cfg.get("max_size", 1333))
    if any(h >= side and w >= side for h, w in buckets):
        return buckets, None
    square = -(-side // 64) * 64
    print(f"tpu.image_buckets: added {square}x{square} for the batches no "
          f"bucket holds (an upright crop of img_transform.max_size {side})")
    return buckets, (square, square)


def main(argv=None, device="cuda"):
    """Train (or with `eval_only` evaluate) as configured -> the train
    state (the stats with `eval_only`)."""
    import torch

    from ..convert import jax_params_to_state_dict, state_dict_to_jax_params
    from ..datasets import build_dataset
    from ..datasets.builder import (collate_fn, get_coco_api_from_dataset,
                                    pack_to)
    from ..engine import TrainState, make_optimizer, make_train_step
    from ..engine.loop import evaluate, train_one_epoch
    from ..models import build_model
    from ..models.factory import postprocessors as model_postprocessors
    from ..parallel import dist as pdist
    from ..parallel import tp as tensor_parallel
    from ..utils.checkpoint import CheckpointManager, load_and_adapt
    from ..utils.config import (FlagshipConfig, dump_config,
                                namespace_to_dict, nested_namespace,
                                parse_cli)
    from ..vis import build_visualizers

    cfg = parse_cli(argv or sys.argv[1:], base="train.yaml")
    args = nested_namespace(cfg)
    tpu_cfg = namespace_to_dict(getattr(args, "tpu", None)) or {}
    if getattr(args, "freeze_detr", False):
        print("freeze_detr: no effect; the JAX package declares it and "
              "freezes nothing either")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli.train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    # the process group of the launcher's environment (none: one process)
    device = pdist.init_process_group(device)
    layout = pdist.make_layout(int(tpu_cfg.get("model_parallel", 1) or 1))
    main_process = layout.rank == 0

    if args.output_dir and main_process:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
        dump_config(cfg, Path(args.output_dir) / "config.yaml")

    np.random.seed(args.seed + layout.data_rank)
    model_cfg = FlagshipConfig.from_config(cfg)
    # every rank draws the same weights; the data ranks then draw their
    # own dropout masks and track-query augmentations
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model, criterion_cfg, postprocess, tracking_cfg = build_model(
        model_cfg, device, generator=generator, train=True)
    if layout.data_rank:
        generator.manual_seed(args.seed + layout.data_rank)
    postprocessors = model_postprocessors(model_cfg)
    vis = build_visualizers(args) if main_process else None

    # datasets + loaders
    dataset_train = build_dataset("train", args) \
        if not args.eval_only else None
    dataset_val = build_dataset("val", args)
    buckets, fallback = image_buckets(tpu_cfg, cfg.get("img_transform") or {})
    max_objects = int(tpu_cfg.get("max_objects", 100))

    def collate(samples):
        return collate_fn(samples, buckets, max_objects,
                          with_masks=args.masks, fallback=fallback)

    def device_put(pack):
        return pack_to(pack, device)

    if getattr(args, "eval_train", False):
        dataset_val = dataset_train or build_dataset("train", args)
    # evaluate on the first tpu.eval_subset images only (0: the whole split)
    eval_subset = int(tpu_cfg.get("eval_subset", 0) or 0)
    if eval_subset and len(dataset_val) > eval_subset:
        print(f"EVAL SUBSET: {eval_subset}/{len(dataset_val)} images")
        dataset_val = _EvalSubset(dataset_val, eval_subset)
    loader_val = Loader(dataset_val, args.batch_size, collate, shuffle=False,
                        process_index=layout.data_rank,
                        process_count=layout.data_size)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"NUM TRAINABLE MODEL PARAMS: {n_params}")

    # warm start: the .npz adapted to this model's shapes, in float32
    resumed = None
    if args.resume and os.path.exists(args.resume):
        own = state_dict_to_jax_params(model.state_dict(), model_cfg)
        resumed = jax_params_to_state_dict(load_and_adapt(
            args.resume, own, resume_shift_neuron=args.resume_shift_neuron))
        model.load_state_dict(resumed)
        print(f"RESUME: {args.resume}")
    if args.load_mask_head_from_model and os.path.exists(
            args.load_mask_head_from_model):
        resumed = load_mask_head(model, args.load_mask_head_from_model)
        print(f"LOADED MASK HEAD: {args.load_mask_head_from_model}")

    steps_per_epoch = (len(dataset_train) // layout.data_size
                       // max(args.batch_size, 1) if dataset_train else 1)
    # split before the optimizer is built: AdamW's moments are per shard
    sharded = tensor_parallel.shard_model(model, layout)
    optimizer = make_optimizer(model_cfg, model,
                               lr_drop_steps=args.lr_drop * steps_per_epoch)
    state = TrainState.create(model, optimizer)
    if resumed is not None:
        shard = tensor_parallel.Shard(layout.model_group, layout.model_rank,
                                      layout.model_size)
        resumed = tensor_parallel.split_state(resumed, sharded, shard)
        with torch.no_grad():  # the master weights at full precision
            for key, t in state.params.items():
                t.copy_(resumed[key])

    ckpt = None
    start_epoch = args.start_epoch
    if args.output_dir:
        ckpt = CheckpointManager(args.output_dir, args.save_model_interval)
        if args.resume_optim:
            # the checkpoint holds one process's full tensors
            full = tensor_parallel.gather_state(state, sharded, layout)
            full, last_epoch = ckpt.restore(full, model if not sharded
                                            else None)
            if sharded:
                tensor_parallel.load_full_state(state, full, model, layout)
            if last_epoch:
                start_epoch = last_epoch + 1

    train_step = make_train_step(model, criterion_cfg, optimizer,
                                 tracking_cfg, tracking=args.tracking,
                                 prev_prev=args.track_prev_prev_frame,
                                 layout=layout)

    def run_eval():
        return evaluate(model, criterion_cfg, postprocessors, loader_val,
                        device_put, get_coco_api_from_dataset(dataset_val),
                        args, vis, obj_detector_model=(model, model_cfg,
                                                       postprocess))

    if args.eval_only:
        stats = run_eval()
        print("EVAL:", {k: v for k, v in stats.items() if np.isscalar(v)})
        return stats

    loader_train = Loader(
        dataset_train, args.batch_size, collate, shuffle=True,
        weights=getattr(dataset_train, "sample_weights", None),
        seed=args.seed, process_index=layout.data_rank,
        process_count=layout.data_size)

    print("START TRAINING")
    start_time = time.time()
    for epoch in range(start_epoch, args.epochs + 1):
        state, train_stats = train_one_epoch(
            train_step, state, loader_train, device_put, epoch, generator,
            print_freq=args.vis_and_log_interval,
            profile_dir=(args.tpu.profile_dir
                         if epoch == start_epoch else ""),
            profile_steps=args.tpu.profile_steps, vis=vis, debug=args.debug)

        val_stats = {}
        if epoch == args.epochs or (args.val_interval
                                    and epoch % args.val_interval == 0):
            val_stats = run_eval()

        if vis is not None:
            vis.log_epoch(epoch, {**train_stats,
                                  **{k: v for k, v in val_stats.items()
                                     if np.isscalar(v)}})
        if ckpt is not None:
            best_metrics = {k: v for k, v in val_stats.items()
                            if k in ("AP", "AP50", "MOTA", "IDF1")}
            full = tensor_parallel.gather_state(state, sharded, layout)
            if main_process:
                ckpt.save(full, epoch, best_metrics, config=model_cfg)
        if args.debug and epoch >= start_epoch:
            break

    total = time.time() - start_time
    print(f"TRAINING DONE in {total / 3600:.2f} h")
    return state


def load_mask_head(model, path) -> dict:
    """Every `mask_head` / `bbox_attention` tensor of the `.npz` at `path`
    (the JAX layout) whose shape is the model's, copied into the model ->
    the model's whole state dict in float32 (the train state's master
    weights start from it)."""
    import torch

    from ..convert import jax_params_to_state_dict, state_dict_to_jax_params
    from ..utils.checkpoint import (flatten_params, load_params_npz,
                                    unflatten_params)

    own = flatten_params(state_dict_to_jax_params(model.state_dict()))
    for key, value in flatten_params(load_params_npz(path)).items():
        if ("mask_head" in key or "bbox_attention" in key) and key in own \
                and own[key].shape == value.shape:
            own[key] = value
    weights = jax_params_to_state_dict(unflatten_params(own))
    with torch.no_grad():
        model.load_state_dict(weights)
    return weights


class _EvalSubset:
    """The first `n` samples of a dataset; other attributes (the ground
    truth the evaluator reads) are the dataset's."""

    def __init__(self, base, n):
        self._base, self._n = base, n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._base[i]

    def __getattr__(self, name):
        return getattr(self._base, name)


if __name__ == "__main__":
    main()
