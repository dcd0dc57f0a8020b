"""The port's multi-process runtime (trackformer_tpu_torch.parallel) on the
CPU: two real processes over gloo, and its pieces in this process.

`tests/torch_parallel_worker.py` runs twice, once per rank, with the JAX
launcher's variables (`COORDINATOR_ADDRESS`, `NUM_PROCESSES`,
`PROCESS_ID`), one thread each and its output in files. The workers
import no JAX (each asserts it): the one-process step they are held
against is held against the JAX package's in `test_torch_train_step.py`.
They check, on a tiny `deformable tracking` model (1 + 1 layers, hidden
96, 4 heads, 8 queries, 64x96 frames, global B = 4, float32):

  * `all_gather_objects` of objects of different sizes, and the
    `CocoEvaluator` merge (each rank one image) against one evaluator;
  * a data-parallel step (2 images a rank, dropout 0, pinned draws) and a
    `tpu.model_parallel: 2` step (dropout 0.1 from one seeded generator,
    the masks drawn at full width) against one process's step on the
    whole batch: loss and `grad_norm` equal on both ranks and to 1e-5
    relative of the one-process step, and so every loss (1e-4); every
    gradient (the TP ones
    gathered) by `gradient_misses` against the one-process float32 step
    and the float64 one;
  * the TP state saved as one process's checkpoint and resumed at TP = 1
    and TP = 2 bit for bit;
  * the fast mode's eval forward split over both ranks (the windowed
    layers gather their whole weights for the window layer) equal to the
    unsplit model's to 1e-5;
  * the training CLI over both ranks: a debug epoch with
    `tpu.model_parallel: 2`, then a data-parallel epoch resumed from its
    checkpoint (the step count goes on).

In this process: the sharded `Loader`'s order against the JAX `Loader`'s,
the tensor-parallel rules in the port's names against the JAX package's,
the split's layout (whole heads, q / k / v each by heads), and the
launcher's variables and the backend choice.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train_step import gradient_misses
from trackformer_tpu.cli.train import Loader as JaxLoader
from trackformer_tpu_torch.cli.train import Loader
from trackformer_tpu_torch.convert import state_dict_to_jax_params
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.parallel import dist as pdist
from trackformer_tpu_torch.parallel import tp
from trackformer_tpu_torch.utils.config import FlagshipConfig

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 300


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both workers' results: {rank: (json results, npz arrays)}."""
    import json

    out = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               NUM_PROCESSES="2", TP_OUT=str(out), PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(2):
        # files, not pipes: a full pipe would stall a worker mid-collective
        log = open(out / f"worker{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_parallel_worker.py")],
            env=dict(env, PROCESS_ID=str(rank)), cwd=str(REPO), stdout=log,
            stderr=subprocess.STDOUT))
    # each worker has WORKER_TIMEOUT; one that fails stops the other at
    # once (it would wait in its next collective)
    deadline = time.monotonic() + WORKER_TIMEOUT
    try:
        while any(p.poll() is None for p in procs) \
                and time.monotonic() < deadline \
                and not any(p.poll() not in (None, 0) for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    results = {}
    for rank, p in enumerate(procs):
        text = (out / f"worker{rank}.log").read_text()
        path = out / f"rank{rank}.json"
        done = json.loads(path.read_text()) if path.exists() else {"done": []}
        arrays = np.load(out / f"rank{rank}.npz") \
            if (out / f"rank{rank}.npz").exists() else None
        results[rank] = (done, arrays, p.returncode, text[-3000:])
    return results


def _passed(workers, check):
    for rank, (done, _, rc, log) in workers.items():
        assert check in done["done"], f"rank {rank} (rc {rc}): {log}"


def test_objects_of_different_sizes_gather(workers):
    _passed(workers, "gather")


def test_coco_evaluator_merges_the_ranks_predictions(workers):
    _passed(workers, "coco_merge")


def _grads(arrays, prefix):
    return {k[len(prefix) + 1:]: torch.from_numpy(arrays[k])
            for k in arrays.files if k.startswith(prefix + "/")}


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_step_over_two_ranks_matches_one_process(workers, mode):
    """Loss and `grad_norm` on both ranks equal, and to 1e-5 relative of
    one process's step on the whole batch; every gradient within the
    float64 bound of `test_torch_train_step.py`."""
    _passed(workers, mode + "_step")
    _passed(workers, "references")
    (res0, arr0, _, _), (res1, arr1, _, _) = workers[0], workers[1]
    assert res0[mode] == res1[mode]
    one = res0[mode + "_one"]
    assert set(res0[mode]) == set(one)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(res0[mode][key], one[key], rtol=1e-5,
                                   err_msg=key)
    # every loss; `class_error` is a ratio within each rank's batch, whose
    # average over the ranks is not the whole batch's
    for key, want in one.items():
        if key != "class_error":
            np.testing.assert_allclose(res0[mode][key], want, rtol=1e-4,
                                       atol=1e-5, err_msg=key)
    grads = _grads(arr0, mode)
    assert set(grads) == set(_grads(arr0, mode + "_one"))
    for key, g in _grads(arr1, mode).items():
        assert torch.equal(g, grads[key]), key
    misses = gradient_misses(grads, _grads(arr0, mode + "_one"),
                             _grads(arr1, mode + "_one"))
    assert misses == [], misses[:5]
    if mode == "tp":
        assert res0["tp_sharded"]


def test_tp_checkpoint_resumes_at_one_and_two_ranks(workers):
    _passed(workers, "tp_checkpoint")


def test_fast_eval_forward_split_over_two_ranks(workers):
    _passed(workers, "tp_fast_eval")


def test_train_cli_over_two_ranks_resumes_its_tp_checkpoint(workers):
    _passed(workers, "train_cli")


class _Samples:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("kind", ["shuffle", "weights", "in_order"])
def test_sharded_loader_order_matches_the_jax_loader(kind):
    """Each rank's batches (epochs 0 and 1) are the JAX `Loader`'s for its
    `process_index`, and the ranks' samples partition the epoch."""
    n, bs = 23, 3
    kw = dict(shuffle=kind != "in_order", seed=4, prefetch=0,
              weights=(np.arange(1, n + 1) if kind == "weights" else None))
    for pi in range(2):
        ours = Loader(_Samples(n), bs, list, process_index=pi,
                      process_count=2, **kw)
        theirs = JaxLoader(_Samples(n), bs, list, process_index=pi,
                           process_count=2, **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):
            assert list(ours) == list(theirs)
    if kind == "in_order":
        seen = [i for pi in range(2) for b in Loader(
            _Samples(n), 1, list, process_index=pi, process_count=2,
            drop_last=False, **kw) for i in b]
        assert sorted(seen) == list(range(n))


def _tiny_model(**over):
    cfg = FlagshipConfig().replace(
        compute_dtype="float32", enc_layers=1, dec_layers=1, hidden_dim=96,
        nheads=4, dim_feedforward=64, num_queries=8, **over)
    return cfg, build_model(cfg, "cpu", torch.Generator().manual_seed(0),
                            train=True)[0]


def test_tp_rules_match_attention_and_ffn():
    """The port's rules split what the JAX package's `RULES` split, leaf
    for leaf (a packed `in_proj` is the JAX q / k / v projections), every
    attention block its whole projection set, every FFN `linear1` and
    `linear2`; norms, embeddings and heads stay replicated. `shard_model`
    splits exactly the ruled tensors."""
    import jax
    from jax.sharding import PartitionSpec as P

    from trackformer_tpu.parallel.tp import param_specs

    cfg, model = _tiny_model()
    sd = model.state_dict()
    ruled = {k: tp.rule_for(k) for k in sd if tp.rule_for(k)}
    specs = param_specs(state_dict_to_jax_params(sd, cfg))
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): s
            for kp, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    jax_split = {p: s for p, s in flat.items() if s != P()}
    # a packed q / k / v tensor is three JAX leaves
    n_port = sum(3 if how == "qkv" else 1 for how in ruled.values())
    assert n_port == len(jax_split)
    for k, how in ruled.items():
        if how == "row":
            assert k.endswith(("out_proj.weight", "output_proj.weight",
                               "linear2.weight")), k
    blocks = {}
    for k in ruled:
        block, leaf = k.rsplit(".", 2)[0], ".".join(k.rsplit(".", 2)[1:])
        if k.endswith(("in_proj_weight", "in_proj_bias")):
            block, leaf = k.rsplit(".", 1)
        blocks.setdefault(block, set()).add(leaf)
    assert any("self_attn" in b for b in blocks)
    msda = {"value_proj.weight", "value_proj.bias", "sampling_offsets.weight",
            "sampling_offsets.bias", "attention_weights.weight",
            "attention_weights.bias", "output_proj.weight"}
    dense = {"in_proj_weight", "in_proj_bias", "out_proj.weight"}
    for k in ruled:
        if "self_attn" in k or "cross_attn" in k:
            owner = k.split(".self_attn")[0] if "self_attn" in k \
                else k.split(".cross_attn")[0]
            attn = "self_attn" if "self_attn" in k else "cross_attn"
            leaves = {x[len(owner) + len(attn) + 2:] for x in ruled
                      if x.startswith(f"{owner}.{attn}.")}
            assert leaves in (msda, dense), (owner, attn, leaves)
        if "linear1" in k:
            stem = k.split("linear1")[0]
            assert {stem + "linear1.weight", stem + "linear1.bias",
                    stem + "linear2.weight"} <= set(ruled)
    assert not any("norm" in k or "level_embed" in k or "_embed." in k
                   for k in ruled)
    layout = pdist.Layout(rank=1, world_size=2, model_size=2)
    assert tp.shard_model(model, layout) == frozenset(ruled)


def test_shard_model_keeps_whole_heads():
    """Rank 1 of 2 holds heads 2-3 of each of q, k and v, of the MSDA
    value / offsets / weights (head-major) and the second half of the FFN;
    the row-parallel tensors split their input features; the modules run
    on 2 heads."""
    cfg, model = _tiny_model()
    full = {k: v.clone() for k, v in model.state_dict().items()}
    tp.shard_model(model, pdist.Layout(rank=1, world_size=2, model_size=2))
    got = model.state_dict()
    c, heads = 96, 4
    attn = "transformer.decoder.layers.0.self_attn"
    for i in range(3):
        want = full[attn + ".in_proj_weight"][i * c:(i + 1) * c]
        np.testing.assert_array_equal(
            got[attn + ".in_proj_weight"][i * c // 2:(i + 1) * c // 2],
            want.view(heads, c // heads, c)[2:].reshape(-1, c))
    msda = "transformer.encoder.layers.0.self_attn"
    for lin in ("value_proj", "sampling_offsets", "attention_weights"):
        w = full[f"{msda}.{lin}.weight"]
        np.testing.assert_array_equal(
            got[f"{msda}.{lin}.weight"],
            w.view(heads, -1, c)[2:].reshape(-1, c))
    np.testing.assert_array_equal(
        got[msda + ".output_proj.weight"],
        full[msda + ".output_proj.weight"][:, c // 2:])
    ffn = "transformer.encoder.layers.0"
    np.testing.assert_array_equal(got[ffn + ".linear1.weight"],
                                  full[ffn + ".linear1.weight"][32:])
    np.testing.assert_array_equal(got[ffn + ".linear2.weight"],
                                  full[ffn + ".linear2.weight"][:, 32:])
    np.testing.assert_array_equal(got[ffn + ".linear2.bias"],
                                  full[ffn + ".linear2.bias"])
    mods = dict(model.named_modules())
    assert mods[msda].n_heads == 2 and mods[attn].num_heads == 2
    with pytest.raises(ValueError, match="heads"):
        tp.shard_model(_tiny_model()[1],
                       pdist.Layout(rank=0, world_size=8, model_size=8))


def test_launch_env_and_backend():
    """torchrun's and the JAX launcher's variables; NCCL with a card per
    rank, gloo when ranks share cards or on the CPU, and a refusal where a
    card is asked for and there is none."""
    env = pdist.launch_env({"RANK": "3", "WORLD_SIZE": "4",
                            "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
                            "MASTER_ADDR": "h", "MASTER_PORT": "7"})
    assert env == pdist.LaunchEnv(3, 4, 1, 2, "tcp://h:7")
    env = pdist.launch_env({"COORDINATOR_ADDRESS": "h:9",
                            "NUM_PROCESSES": "2", "PROCESS_ID": "1"})
    assert env == pdist.LaunchEnv(1, 2, 1, 2, "tcp://h:9")
    assert pdist.launch_env({}) is None
    assert pdist.choose_backend("cuda", 2, 2) == "nccl"
    assert pdist.choose_backend("cuda", 2, 1) == "gloo"
    assert pdist.choose_backend("cpu", 2, 0) == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.choose_backend("cuda", 1, 0)
    batch = {"x": torch.arange(8).view(4, 2), "y": [np.arange(4), None]}
    part = pdist.shard_batch(batch, 1, 2)
    assert part["x"].tolist() == [[4, 5], [6, 7]]
    assert part["y"][0].tolist() == [2, 3] and part["y"][1] is None


def test_launches_at_split_heads_key_their_heads():
    """A tensor-parallel rank's MSDA launches (4 of the 8 heads) are
    counted apart from the whole model's."""
    from trackformer_tpu_torch.ops import msda
    msda.reset_launch_counts()
    try:
        msda.count_launch("msda_bwd", 2, 5, ((1, 2),), 36, 8)
        msda.count_launch("msda_bwd", 2, 5, ((1, 2),), 36, 4)
        msda.count_launch("msda_patch", 2, 5, ((1, 2),), 36, 4)
        assert msda.launch_shapes() == {
            ("msda_bwd", 2, 5, ((1, 2),), 36): 1,
            ("msda_bwd", 2, 5, ((1, 2),), 36, 4): 1,
            ("msda_patch", 2, 5, ((1, 2),), 36, 4): 1}
    finally:
        msda.reset_launch_counts()
