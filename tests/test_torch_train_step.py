"""The port's training step (trackformer_tpu_torch.engine) held against the
JAX package on the CPU: the optimizer group of every tensor, the
learning-rate schedule, and two full optimizer steps of two-frame
track-query training of a tiny flagship (1 + 1 layers, hidden 96, 4 heads,
8 queries, 64x96 frames, float32).

The same JAX-initialized weights go through `convert.py` into the port;
frames, boxes and track ids are made with numpy from a seed. Dropout is 0
and the track-query draws are pinned on both sides (`forced`), because no
`torch.Generator` draw equals `jax.random`'s. The JAX step's gradients are
read out of an optax transform chained in front of its optimizer, and come
to the port's names through the same `convert.py` map as the weights.

Tolerances (float32 on both sides, sums in different orders through a
ResNet-50 and the transformer):
  * every loss key, the total and `grad_norm`: 1e-4 relative;
  * gradients, name by name: 1e-4 + 1e-3 |ref| elementwise;
  * weights after each step: Adam divides each gradient by its own running
    magnitude, so an element whose gradient is nearly zero moves by up to
    the learning rate in either direction whatever its error is. The update
    of each tensor is therefore held as a whole: |update - ref|_2 <= 1e-2
    |ref|_2, which a wrong group learning rate, moment, weight decay or
    clip factor breaks by a factor; frozen tensors are bit-identical to
    their start.
The learning rate drops x0.1 before the second step, so the schedule is in
the comparison too.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trackformer_tpu.engine import train_step as jtrain
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models import tracking as jtracking
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import Targets as JTargets
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.engine import (TrainState, label_params,
                                          make_optimizer, make_train_step)
from trackformer_tpu_torch.engine.train_step import GROUPS, train_tensors
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch, Targets
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

NAMED = ["deformable", "tracking", "multi_frame"]
TINY = {"enc_layers": 1, "dec_layers": 1, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8, "dropout": 0.0}
B, T, H, W = 2, 5, 64, 96
LR_DROP_STEP = 1
FORCED = {"num": 2, "num_fps": 1,
          "order": np.tile(np.arange(T), (B, 1)),
          "fp_seed_pos": np.tile(np.arange(T), (B, 1))}


def jax_args():
    args = nested_namespace(load_config(
        "train.yaml", NAMED, {**TINY, "tpu.compute_dtype": "float32"}))
    args.lr_drop_steps = LR_DROP_STEP
    return args


def tiny_cfg() -> FlagshipConfig:
    return FlagshipConfig().replace(compute_dtype="float32", **TINY)


def make_pack():
    """Two frames of B images with 3 and 2 objects; one object of image 0
    leaves between the frames, so its track query is a false positive."""
    rng = np.random.RandomState(0)
    valid_hw = np.array([[60, 90]] * B, np.int32)
    packs = []
    centre = rng.uniform(0.25, 0.75, (B, T, 2))
    size = rng.uniform(0.1, 0.3, (B, T, 2))
    for frame in range(2):
        img = rng.randn(B, H, W, 3).astype(np.float32)
        boxes = np.concatenate(
            [centre + 0.02 * frame * rng.randn(B, T, 2), size], -1)
        valid = np.zeros((B, T), bool)
        valid[0, :3] = True
        valid[1, :2] = True
        ids = np.where(valid, np.arange(T)[None], -1).astype(np.int32)
        if frame == 1:
            ids[0, 1] = 7
        tgt = dict(labels=np.zeros((B, T), np.int32),
                   boxes=boxes.astype(np.float32), valid=valid,
                   track_ids=ids, orig_size=np.tile([[H, W]], (B, 1))
                   .astype(np.int32), size=valid_hw,
                   image_id=np.arange(B, dtype=np.int32))
        packs.append((img, valid_hw, tgt))
    return packs


def jax_pack(packs):
    out = {}
    for prefix, (img, valid_hw, tgt) in zip(("prev_", ""), packs):
        out[prefix + "batch"] = JFrameBatch.from_images(
            jnp.asarray(img), jnp.asarray(valid_hw))
        out[prefix + "targets"] = JTargets(
            **{k: jnp.asarray(v) for k, v in tgt.items()})
    return out


def torch_pack(packs):
    out = {}
    for prefix, (img, valid_hw, tgt) in zip(("prev_", ""), packs):
        out[prefix + "batch"] = FrameBatch.from_images(
            torch.from_numpy(img), torch.from_numpy(valid_hw))
        out[prefix + "targets"] = Targets(
            **{k: torch.from_numpy(v) for k, v in tgt.items()})
    return out


@pytest.fixture(scope="module")
def setup():
    args = jax_args()
    jmodel, jcrit, _, jtrack = jax_build_model(args)
    packs = make_pack()
    jpack = jax_pack(packs)
    params = jmodel.init(jax.random.PRNGKey(0), jpack["batch"])
    params = jax.tree.map(np.asarray, params)
    # perturb the zero-initialized heads and offsets: every path carries
    # gradient, and no sample sits on a cell border (the initial offsets
    # are whole cells, where the location gradient jumps)
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    cfg = tiny_cfg()
    tmodel, tcrit, _, ttrack = build_model(cfg, "cpu", train=True)
    tmodel.load_state_dict(jax_params_to_state_dict(params))
    return types.SimpleNamespace(
        args=args, jmodel=jmodel, jcrit=jcrit, jtrack=jtrack, params=params,
        jpack=jpack, cfg=cfg, tmodel=tmodel, tcrit=tcrit, ttrack=ttrack,
        tpack=torch_pack(packs))


def test_train_configs_match_the_jax_factory(setup):
    s = setup
    assert s.tmodel.training
    assert s.tcrit.num_classes == s.jcrit.num_classes
    assert s.tcrit.weight_dict == dict(s.jcrit.weight_dict)
    for name in ("eos_coef", "focal_loss", "focal_alpha", "focal_gamma",
                 "tracking", "track_query_false_positive_eos_weight",
                 "losses"):
        assert getattr(s.tcrit, name) == getattr(s.jcrit, name), name
    for name in ("cost_class", "cost_bbox", "cost_giou", "focal_loss",
                 "focal_alpha", "focal_gamma"):
        assert getattr(s.tcrit.matcher, name) == getattr(s.jcrit.matcher,
                                                         name), name
        assert getattr(s.ttrack.matcher, name) == getattr(s.jtrack.matcher,
                                                          name), name
    for name in ("false_positive_prob", "false_negative_prob",
                 "backprop_prev_frame"):
        assert getattr(s.ttrack, name) == getattr(s.jtrack, name), name


def test_param_groups_match_label_params(setup):
    """Every tensor's optimizer group: the JAX label tree, each leaf filled
    with its group's index, goes through the weight map and must arrive
    constant and equal to the port's own label."""
    s = setup
    jlabels = jtrain.label_params(s.params)
    filled = jax.tree.map(
        lambda lab, x: np.full(x.shape, GROUPS.index(lab), np.float32),
        jlabels, s.params)
    arrived = jax_params_to_state_dict(filled)
    labels = label_params(s.tmodel)
    assert set(labels) == set(arrived) == set(train_tensors(s.tmodel))
    for name, lab in labels.items():
        got = arrived[name].unique().tolist()
        assert got == [float(GROUPS.index(lab))], (name, lab, got)
    counts = {g: sum(1 for v in labels.values() if v == g) for g in GROUPS}
    assert counts["frozen"] > 100 and counts["backbone"] > 20
    assert counts["linear_proj"] == 2 * 2 + 2    # 2 offset layers + ref pts
    # lr_backbone 0 freezes the whole trunk
    frozen_trunk = label_params(s.tmodel, lr_backbone_trainable=False)
    assert not any(v == "backbone" for v in frozen_trunk.values())


def test_schedule_matches_optax(setup):
    cfg = setup.cfg.replace(lr_warmup_steps=4)
    opt = make_optimizer(cfg, setup.tmodel, lr_drop_steps=[6, 3])
    base = optax.piecewise_constant_schedule(1.0, {3: 0.1, 6: 0.1})
    for step in range(9):
        want = float(base(step)) * min(1.0, (step + 1) / 4)
        assert opt.lr_scale(step) == pytest.approx(want, rel=1e-6), step
    assert opt.group_lr == {
        "base": cfg.lr, "backbone": cfg.lr_backbone,
        "linear_proj": cfg.lr * cfg.lr_linear_proj_mult,
        "track": cfg.lr_track}
    assert (opt.weight_decay, opt.clip_max_norm) == (1e-4, 0.1)
    assert (opt.b1, opt.b2, opt.eps) == (0.9, 0.999, 1e-8)


def recording_optimizer(optimizer):
    """`optimizer` behind a transform that keeps the raw gradients in its
    state, so that a jitted step hands them out."""
    record = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(record, optimizer)


def test_two_train_steps_match_jax(setup, monkeypatch):
    s = setup
    real = jtracking.add_track_queries_to_targets
    monkeypatch.setattr(
        jtracking, "add_track_queries_to_targets",
        lambda *a, **kw: real(*a, **{**kw, "forced": FORCED}))
    joptimizer = recording_optimizer(jtrain.make_optimizer(s.args, s.params))
    jstate = jtrain.TrainState.create(s.params, joptimizer)
    jstep = jax.jit(jtrain.make_train_step(s.jmodel, s.jcrit, joptimizer,
                                           s.jtrack, tracking=True))

    optimizer = make_optimizer(s.cfg, s.tmodel, lr_drop_steps=LR_DROP_STEP)
    state = TrainState.create(s.tmodel, optimizer)
    step = make_train_step(s.tmodel, s.tcrit, optimizer, s.ttrack,
                           tracking=True, return_grads=True)
    start = {k: v.detach().clone()
             for k, v in train_tensors(s.tmodel).items()}
    before = start
    jbefore = jax_params_to_state_dict(s.params)

    for it in range(2):
        jstate, jmetrics = jstep(jstate, s.jpack, jax.random.PRNGKey(it))
        state, metrics = step(state, s.tpack, None, forced=FORCED)
        assert state.step == it + 1 == int(jstate.step)

        assert set(metrics) - {"_grads"} == set(jmetrics)
        assert set(s.tcrit.weight_dict) <= set(metrics)
        for key, want in jmetrics.items():
            np.testing.assert_allclose(
                float(metrics[key]), float(want), rtol=1e-4, atol=1e-4,
                err_msg=f"step {it} {key}")

        jgrads = jax_params_to_state_dict(
            jax.tree.map(np.asarray, jstate.opt_state[0]))
        grads = metrics["_grads"]
        assert set(grads) == set(jgrads)
        for name, want in jgrads.items():
            np.testing.assert_allclose(
                grads[name].numpy(), want.numpy(), rtol=1e-3, atol=1e-4,
                err_msg=f"step {it} gradient {name}")

        jafter = jax_params_to_state_dict(
            jax.tree.map(np.asarray, jstate.params))
        after = {k: v.detach().clone()
                 for k, v in train_tensors(s.tmodel).items()}
        for name, lab in optimizer.labels.items():
            if lab == "frozen":
                assert torch.equal(after[name], start[name]), name
                assert torch.equal(jafter[name], jbefore[name]), name
                continue
            assert torch.equal(after[name], state.params[name]), name
            want = jafter[name] - jbefore[name]
            got = after[name] - before[name]
            err = (got - want).norm().item()
            assert want.norm().item() > 0, name
            assert err <= 1e-2 * want.norm().item(), (
                f"step {it} update of {name}: {err} of "
                f"{want.norm().item()}")
            # and no element further than the step's largest possible move
            lr = optimizer.group_lr[lab] * optimizer.lr_scale(it)
            assert (after[name] - jafter[name]).abs().max().item() \
                <= 2.2 * lr * (it + 1), name
        before, jbefore = after, jafter
    # the learning rate dropped between the steps
    assert optimizer.lr_scale(0) == 1.0
    assert optimizer.lr_scale(1) == pytest.approx(0.1)


def test_detection_step_and_bf16_master_weights(setup):
    """`tracking=False` takes a plain detection step; a bfloat16 model
    trains through float32 master weights that the model's parameters are
    the cast copy of."""
    cfg = setup.cfg.replace(compute_dtype="bfloat16", dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    model, crit, _, track = build_model(cfg, "cpu", generator=gen,
                                        train=True)
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, crit, optimizer, track, tracking=False)
    name = "transformer.decoder.layers.0.linear1.weight"
    before = state.params[name].clone()
    state, metrics = step(state, setup.tpack, gen)
    assert "_grads" not in metrics        # gradients only on request
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    master = state.params[name]
    assert master.dtype == torch.float32 and not torch.equal(master, before)
    param = dict(model.named_parameters())[name]
    assert param.dtype == torch.bfloat16
    assert torch.equal(param, master.to(torch.bfloat16))
    assert all(v.dtype == torch.float32 for v in state.mu.values())
    with pytest.raises(NotImplementedError, match="TPU-fast"):
        build_model(FlagshipConfig.tpu_fast(), "cpu", train=True)


def test_entry_points_default_to_the_card(setup):
    """Every public entry point that makes tensors runs on the card unless
    the caller asks for the CPU: the default device is CUDA, and on a
    machine without one the call raises rather than quietly running on the
    CPU. Entry points that take a model or tensors follow their device."""
    import inspect

    from trackformer_tpu_torch.structures import empty_targets
    from trackformer_tpu_torch.tracking import BatchedTracker, Tracker
    from trackformer_tpu_torch.tracking.tracker import init_state
    for fn in (build_model, init_state, empty_targets):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__name__
    if not torch.cuda.is_available():
        for call in (lambda: build_model(setup.cfg),
                     lambda: build_model(setup.cfg, train=True),
                     lambda: init_state(4, 8),
                     lambda: empty_targets(1, 1)):
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    cfg, model = setup.cfg, setup.tmodel
    post = build_model(cfg, "cpu")[1]
    tracker_cfg = {**cfg.tracker_cfg, "max_tracks": 4}
    for cls in (Tracker, BatchedTracker):
        tracker = cls(model, post, tracker_cfg, cfg.hidden_dim,
                      cfg.num_queries)
        assert tracker.device == next(model.parameters()).device
    state = TrainState.create(model, make_optimizer(cfg, model))
    assert {t.device for t in state.mu.values()} == {torch.device("cpu")}


def test_train_one_epoch_meters_and_aborts(capsys):
    """The epoch loop: every pack goes through `device_put` and the step,
    the meter averages each metric (keys with a leading underscore are not
    logged), and a non-finite loss stops the run with exit code 1."""
    from trackformer_tpu_torch.engine.loop import train_one_epoch

    seen = []

    def fake_step(state, pack, generator):
        seen.append(pack)
        return state + 1, {"loss": torch.tensor(float(pack["x"])),
                           "grad_norm": torch.tensor(2.0),
                           "_grads": {"w": torch.zeros(1)}}

    state, averages = train_one_epoch(
        fake_step, 0, [{"x": 1.0}, {"x": 3.0}], lambda p: {**p, "put": True},
        epoch=4, generator=None, print_freq=1)
    assert state == 2 and all(p["put"] for p in seen)
    assert averages == {"loss": 2.0, "grad_norm": 2.0}
    assert "Epoch: [4] step 1 loss=3.0000" in capsys.readouterr().out
    with pytest.raises(SystemExit) as stop:
        train_one_epoch(fake_step, 0, [{"x": 1.0}, {"x": float("nan")}],
                        lambda p: {**p, "put": True}, 0, None)
    assert stop.value.code == 1
