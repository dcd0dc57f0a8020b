"""One of the two processes of `tests/test_torch_parallel.py`: the port's
`torch.distributed` runtime over gloo on the CPU, without JAX.

Joins the group through `parallel.dist.init_process_group` from the JAX
launcher's variables (`COORDINATOR_ADDRESS`, `NUM_PROCESSES`,
`PROCESS_ID`), then:

  1. `all_gather_objects` of objects of different sizes;
  2. the `CocoEvaluator` merge: each rank holds one image's detections;
  3. a data-parallel train step of a tiny `deformable tracking` model
     (global B = 4, 2 a rank, dropout 0, the track-query draws pinned);
  4. a `tpu.model_parallel: 2` step of the same model (both ranks on the
     whole batch, dropout 0.1 from one seeded generator);
  5. the tensor-parallel state saved as one process's checkpoint,
     restored at TP = 1 and at TP = 2;
  6. the fast mode's eval forward split over both ranks (its windowed
     layers gather their weights for the window layer) against the
     unsplit model's;
  7. the training CLI over both ranks: a debug epoch of the tiny model
     with `tpu.model_parallel: 2`, then a data-parallel one resumed from
     its checkpoint.

Each rank also runs the one-process reference steps on the whole batch
(rank 0 in float32, rank 1 in float64) and writes its results to
`<TP_OUT>/rank<r>.npz` / `.json` for the test to compare.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from trackformer_tpu_torch.datasets.coco_eval import CocoEvaluator  # noqa
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,  # noqa
                                          make_train_step)
from trackformer_tpu_torch.models import build_model  # noqa
from trackformer_tpu_torch.parallel import dist as pdist  # noqa
from trackformer_tpu_torch.parallel import tp  # noqa
from trackformer_tpu_torch.structures import FrameBatch, Targets  # noqa
from trackformer_tpu_torch.utils.checkpoint import CheckpointManager  # noqa
from trackformer_tpu_torch.utils.config import FlagshipConfig  # noqa

torch.set_num_threads(1)
OUT = Path(os.environ["TP_OUT"])
TINY = dict(compute_dtype="float32", enc_layers=1, dec_layers=1,
            hidden_dim=96, nheads=4, dim_feedforward=64, num_queries=8)
B, T, H, W = 4, 5, 64, 96
VALID = (3, 2, 4, 2)                       # objects in each image
FORCED = {"num": 2, "num_fps": 1,
          "order": np.tile(np.arange(T), (B, 1)),
          "fp_seed_pos": np.tile(np.arange(T), (B, 1))}


def make_pack(seed=1):
    """Two frames of B images; one object of image 0 leaves between them."""
    rng = np.random.RandomState(seed)
    valid_hw = np.array([[60, 90]] * B, np.int32)
    centre = rng.uniform(0.25, 0.75, (B, T, 2))
    size = rng.uniform(0.1, 0.3, (B, T, 2))
    valid = np.arange(T)[None] < np.array(VALID)[:, None]
    pack = {}
    for frame, prefix in enumerate(("prev_", "")):
        img = rng.randn(B, H, W, 3).astype(np.float32)
        boxes = np.concatenate(
            [centre + 0.02 * frame * rng.randn(B, T, 2), size], -1)
        ids = np.where(valid, np.arange(T)[None], -1).astype(np.int32)
        if frame == 1:
            ids[0, 1] = 7
        tgt = dict(labels=np.zeros((B, T), np.int32),
                   boxes=boxes.astype(np.float32), valid=valid,
                   track_ids=ids,
                   orig_size=np.tile([[H, W]], (B, 1)).astype(np.int32),
                   size=valid_hw, image_id=np.arange(B, dtype=np.int32))
        pack[prefix + "batch"] = FrameBatch.from_images(
            torch.from_numpy(img), torch.from_numpy(valid_hw))
        pack[prefix + "targets"] = Targets(
            **{k: torch.from_numpy(v) for k, v in tgt.items()})
    return pack


def tiny_model(dropout, dtype=torch.float32):
    """The tiny model, the same weights on every rank: the port's init from
    seed 0, with the heads and offsets perturbed off their zero / whole-cell
    init (every path carries gradient, no sample on a cell border)."""
    cfg = FlagshipConfig().replace(dropout=dropout, **TINY)
    model, crit, _, track = build_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0), train=True)
    noise = np.random.RandomState(1)
    with torch.no_grad():
        for key, t in sorted(model.state_dict().items()):
            if "sampling_offsets" in key or "attention_weights" in key \
                    or ("bbox_embed" in key and "layers.2" in key):
                t.add_(torch.from_numpy(
                    0.02 * noise.randn(*t.shape).astype(np.float32)))
    model.to(dtype)
    return cfg, model, crit, track


def run_step(dropout, pack, forced, layout=None, dtype=torch.float32,
             model_parallel=False):
    """One train step -> (model, state, metrics) with the gradients."""
    cfg, model, crit, track = tiny_model(dropout, dtype)
    if model_parallel:
        tp.shard_model(model, layout)
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, crit, optimizer, track, tracking=True,
                           return_grads=True, layout=layout)
    gen = torch.Generator().manual_seed(5)
    state, metrics = step(state, pack, gen, forced=forced)
    return cfg, model, state, metrics


def load_chip_smoke():
    """chip_smoke.py as a module (its data writers)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scalars(metrics):
    return {k: float(v) for k, v in metrics.items() if not k.startswith("_")}


def main():
    pdist.init_process_group("cpu")
    rank = pdist.rank()
    assert pdist.world_size() == 2
    results, arrays = {"done": []}, {}

    def done(check):
        """Record a passed check (the file is rewritten after each)."""
        results["done"].append(check)
        (OUT / f"rank{rank}.json").write_text(json.dumps(results))

    # 1. objects of different sizes, in rank order
    got = pdist.all_gather_objects({"rank": rank,
                                    "data": list(range(3 + 50 * rank))})
    assert [g["rank"] for g in got] == [0, 1]
    assert [len(g["data"]) for g in got] == [3, 53]
    done("gather")

    # 2. the evaluator's merge: image `rank` on this rank
    class GT:
        anns_by_image = {i: [{"bbox": [10.0 + i, 12.0, 20.0, 16.0],
                              "category_id": 1, "iscrowd": 0,
                              "area": 320.0}] for i in range(2)}
    preds = {i: {"boxes": np.array([[10.0 + i, 12.0, 31.0, 27.0],
                                    [50.0, 50.0, 60.0, 70.0]]),
                 "scores": np.array([0.9, 0.3 + 0.2 * i]),
                 "labels": np.array([1, 1])} for i in range(2)}
    evaluator = CocoEvaluator(GT())
    evaluator.update({rank: preds[rank]})
    evaluator.synchronize_between_processes()
    assert sorted(evaluator.predictions) == [0, 1]
    one = CocoEvaluator(GT())
    one.update(preds)
    np.testing.assert_equal(evaluator.summarize(), one.summarize())
    done("coco_merge")

    pack = make_pack()

    # 3. data parallel: 2 images a rank
    layout = pdist.make_layout(1)
    assert (layout.data_size, layout.data_rank) == (2, rank)
    local = pdist.shard_batch(pack, rank, 2)
    forced = {**FORCED, "order": FORCED["order"][2 * rank:2 * rank + 2],
              "fp_seed_pos": FORCED["fp_seed_pos"][2 * rank:2 * rank + 2]}
    _, _, _, dp = run_step(0.0, local, forced, layout)
    results["dp"] = scalars(dp)
    arrays.update({"dp/" + k: v.numpy() for k, v in dp["_grads"].items()})
    done("dp_step")

    # 4. tensor parallel over both ranks, dropout 0.1
    pdist.reset_layout()
    layout = pdist.make_layout(2)
    assert (layout.data_size, layout.model_size) == (1, 2)
    cfg, model, state, tpm = run_step(0.1, pack, FORCED, layout,
                                      model_parallel=True)
    results["tp"] = scalars(tpm)
    shard = tp.Shard(layout.model_group, layout.model_rank, 2)
    for k, g in tpm["_grads"].items():
        full = tp.gather_tensor(g, tp.rule_for(k), shard) \
            if k in model.tp_sharded else g
        arrays["tp/" + k] = full.numpy()
    results["tp_sharded"] = sorted(model.tp_sharded)
    done("tp_step")

    # 5. the checkpoint: one process's layout, resumed at TP = 1 and 2
    full = tp.gather_state(state, model.tp_sharded, layout)
    ckpt_dir = OUT / "ckpt"
    if rank == 0:
        CheckpointManager(ckpt_dir).save(full, 1, {}, cfg)
    torch.distributed.barrier()
    _, one_model, _, _ = tiny_model(0.1)
    one_state = TrainState.create(one_model, make_optimizer(cfg, one_model))
    one_state, epoch = CheckpointManager(ckpt_dir).restore(one_state,
                                                           one_model)
    assert epoch == 1 and one_state.step == 1
    for name in ("params", "mu", "nu"):
        for k, v in getattr(full, name).items():
            assert torch.equal(getattr(one_state, name)[k], v), (name, k)
    _, back, _, _ = tiny_model(0.1)
    tp.shard_model(back, layout)
    back_state = TrainState.create(back, make_optimizer(cfg, back))
    again = tp.gather_state(back_state, back.tp_sharded, layout)
    again, _ = CheckpointManager(ckpt_dir).restore(again)
    tp.load_full_state(back_state, again, back, layout)
    for k, v in state.params.items():
        assert torch.equal(back_state.params[k], v), k
        assert torch.equal(back.state_dict()[k], v), k
    torch.distributed.barrier()
    done("tp_checkpoint")

    # 6. the fast mode's eval forward split over both ranks: its windowed
    # layers gather their whole weights for the window layer
    from trackformer_tpu_torch.structures import empty_targets
    fast_cfg = FlagshipConfig.tpu_fast(**{**TINY, "enc_layers": 2})
    outs = []
    for split in (False, True):
        fast = build_model(fast_cfg, "cpu",
                           torch.Generator().manual_seed(0))[0]
        if split:
            tp.shard_model(fast, layout)
        with torch.no_grad():
            out = fast(pack["batch"], empty_targets(B, 1, "cpu"))[0]
        outs.append(out)
    for key in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(outs[1][key], outs[0][key], rtol=1e-5,
                                   atol=1e-5)
    done("tp_fast_eval")

    # 7. the training CLI over both ranks: a debug epoch with
    # tpu.model_parallel 2 (rank 0 writes the checkpoint), then one
    # data-parallel epoch resumed from it (at TP = 1)
    from trackformer_tpu_torch.cli.train import main as train_main
    data = OUT / "data"
    if rank == 0:
        smoke = load_chip_smoke()
        smoke.write_mot_sequences(data, ["MOT17-02-FRCNN"], 4, hw=(54, 96),
                                  ext="jpg")
        from trackformer_tpu_torch.tools.generate_coco_from_mot import \
            main as convert
        convert(["mot17", "--data-root", str(data / "MOT17")])
    torch.distributed.barrier()
    argv = ["with", "deformable", "tracking", "multi_frame", "enc_layers=1",
            "dec_layers=1", "hidden_dim=96", "nheads=4",
            "dim_feedforward=64", "num_queries=8", "dataset=mot",
            f"mot_path_train={data}/MOT17", f"mot_path_val={data}/MOT17",
            "train_split=mot17_train_coco", "val_split=mot17_train_coco",
            "img_transform.val_width=64", "img_transform.max_size=114",
            "tpu.image_buckets=[[128,128]]", "tpu.max_objects=4",
            "tpu.compute_dtype=float32", "tracking_eval=false", "debug=true",
            "batch_size=1", f"output_dir={OUT / 'cli'}"]
    pdist.reset_layout()
    state = train_main(argv + ["epochs=1", "tpu.model_parallel=2"],
                       device="cpu")
    torch.distributed.barrier()         # rank 0 has saved
    assert state.step == 2 and (OUT / "cli" / "checkpoint.pt").exists()
    pdist.reset_layout()
    state = train_main(argv + ["epochs=2", "resume_optim=true"],
                       device="cpu")
    assert state.step == 4, state.step
    done("train_cli")

    # the one-process references on the whole batch
    dtype = torch.float32 if rank == 0 else torch.float64
    pdist.reset_layout()
    for name, dropout in (("dp", 0.0), ("tp", 0.1)):
        _, _, _, ref = run_step(dropout, pack, FORCED, pdist.Layout(),
                                dtype=dtype)
        results[f"{name}_one"] = scalars(ref)
        arrays.update({f"{name}_one/" + k: v.numpy()
                       for k, v in ref["_grads"].items()})
    assert "jax" not in sys.modules and "flax" not in sys.modules
    np.savez(OUT / f"rank{rank}.npz", **arrays)
    done("references")
    torch.distributed.barrier()
    if rank == 0:       # the checkpoints take ~1 GB
        import shutil
        for sub in ("ckpt", "cli", "data"):
            shutil.rmtree(OUT / sub, ignore_errors=True)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
