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
  * gradients, name by name, held against a float64 reference: the
    port's two steps once more in float64 on the CPU, from the same weights
    with the same draws (`float64_steps`). With r the float64 gradient and
    d_p, d_j the port's and the JAX float32 step's departures from it,
    each side must satisfy, tensor by tensor,
        |d_j|_2 <= 4e-3 |r|_2 + 4 |d_p|_2   (and the same with p, j swapped)
    and, element by element,
        |d_j| <= 0.25 rms(r) + 4 |d_p|      (likewise swapped).
    A fault in the port's code moves both of its steps and so shows as
    d_j; one in its float32 arithmetic shows as d_p. The terms in |r|
    cover what float32 does to a gradient besides rounding: a sampling
    location or a ReLU input within float32 noise of a kink, where the
    gradient jumps, can land on the other side in one framework (on some
    CPUs at the second step: every gradient of the trunk's `layer2.2` and
    upstream 1e-3 of its norm off, in JAX only), and Adam's per-element
    normalisation makes each float32 trajectory part from the float64
    one by up to a learning rate per element before the second step.
    Measured on this fixture: |d|_2 up to 1.36e-3 |r|_2, and 0.076 rms(r)
    over 4 |d| for an element. `test_float64_bound_rejects_a_planted_fault` holds that
    the bound still rejects one gradient tensor scaled by 1.01.
  * weights after each step: Adam divides each gradient by its own running
    magnitude, so an element whose gradient is nearly zero moves by up to
    the learning rate in either direction whatever its error is. The update
    of each tensor is therefore held as a whole: |update - ref|_2 <= 1e-2
    |ref|_2, which a wrong group learning rate, moment, weight decay or
    clip factor breaks by a factor; frozen tensors are bit-identical to
    their start.
The learning rate drops x0.1 before the second step, so the schedule is in
the comparison too.

The trunk's gradients jump where a ReLU input changes sign, and the two
frameworks' float32 convolutions differ by ~2e-6: an input that close to
0 can fall on either side. `trunk_sign_flips` finds such inputs; a test
holds the fixture free of them at both steps, and

    python tests/test_torch_train_step.py [pack seed]

prints them for another draw of the pack.
"""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trackformer_tpu.engine import train_step as jtrain
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models.backbone import RESNET_LAYERS, ResNet
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


def jax_args(named=NAMED, tiny=TINY):
    args = nested_namespace(load_config(
        "train.yaml", named, {**tiny, "tpu.compute_dtype": "float32"}))
    args.lr_drop_steps = LR_DROP_STEP
    return args


def tiny_cfg(fast: bool = False, tiny=TINY) -> FlagshipConfig:
    base = FlagshipConfig.tpu_fast() if fast else FlagshipConfig()
    return base.replace(compute_dtype="float32", **tiny)


# the draw of the frames and boxes (`make_pack`)
PACK_SEED = 1


def make_pack(seed=PACK_SEED):
    """Two frames of B images with 3 and 2 objects; one object of image 0
    leaves between the frames, so its track query is a false positive.

    The draw is seed 1. Seed 0's second step put one pre-activation of the
    ReLU after `layer2.1.bn2` (frame 1, image 0, row 2, column 8, channel
    56) at 4.8e-7 in JAX and -1.6e-7 in the port: within the two
    frameworks' float32 convolution noise (2e-6 at that layer) of the
    kink, where the ReLU passes its gradient on one side and not the
    other, so every trunk gradient upstream of it parted. Any draw has
    pre-activations that near 0; with seed 1 none of the trunk's changes
    sign between the two frameworks at either step
    (`test_trunk_relus_keep_their_sign`)."""
    rng = np.random.RandomState(seed)
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


def make_setup(pack_seed=PACK_SEED, fast: bool = False, tiny=TINY):
    """Both packages' tiny models (sizes `tiny`) from one JAX init, the
    pack, and the training configs; `fast`: the TPU-fast mode (`tpu_fast`
    on top)."""
    args = jax_args(NAMED + ["tpu_fast"] if fast else NAMED, tiny)
    jmodel, jcrit, _, jtrack = jax_build_model(args)
    packs = make_pack(pack_seed)
    jpack = jax_pack(packs)
    # jitted: the eager init of the ResNet-50 trunk takes ~80 s on the
    # CPU; the jitted one draws the same bits in ~16 s
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jpack["batch"])
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
    cfg = tiny_cfg(fast, tiny)
    tmodel, tcrit, _, ttrack = build_model(cfg, "cpu", train=True)
    tmodel.load_state_dict(jax_params_to_state_dict(params))
    return types.SimpleNamespace(
        args=args, jmodel=jmodel, jcrit=jcrit, jtrack=jtrack, params=params,
        jpack=jpack, cfg=cfg, tmodel=tmodel, tcrit=tcrit, ttrack=ttrack,
        packs=packs, tpack=torch_pack(packs))


@pytest.fixture(scope="module")
def setup():
    return make_setup()


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


def jax_steps(s):
    """Two steps of the JAX train step with the pinned draws: per step its
    metrics, gradients and weights (in the port's names, and the JAX tree
    under `params`), then the start weights."""
    real = jtracking.add_track_queries_to_targets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracking, "add_track_queries_to_targets",
                   lambda *a, **kw: real(*a, **{**kw, "forced": FORCED}))
        joptimizer = recording_optimizer(
            jtrain.make_optimizer(s.args, s.params))
        jstate = jtrain.TrainState.create(s.params, joptimizer)
        jstep = jax.jit(jtrain.make_train_step(s.jmodel, s.jcrit, joptimizer,
                                               s.jtrack, tracking=True))
        steps = []
        for it in range(2):
            jstate, jmetrics = jstep(jstate, s.jpack, jax.random.PRNGKey(it))
            steps.append(dict(
                step=int(jstate.step),
                metrics={k: float(v) for k, v in jmetrics.items()},
                grads=jax_params_to_state_dict(
                    jax.tree.map(np.asarray, jstate.opt_state[0])),
                after=jax_params_to_state_dict(
                    jax.tree.map(np.asarray, jstate.params)),
                params=jax.tree.map(np.asarray, jstate.params)))
    return steps, jax_params_to_state_dict(s.params)


@pytest.fixture(scope="module")
def jax_two_steps(setup):
    return jax_steps(setup)


def port_steps(s, dtype):
    """The port's two steps from the fixture's weights with the pinned
    draws, its model in `dtype` on the CPU: each step's float32 gradients
    by state-dict key."""
    model = build_model(s.cfg, "cpu", train=True)[0]
    model.load_state_dict(jax_params_to_state_dict(s.params))
    model.to(dtype)
    optimizer = make_optimizer(s.cfg, model, lr_drop_steps=LR_DROP_STEP)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, s.tcrit, optimizer, s.ttrack,
                           tracking=True, return_grads=True)
    grads = []
    for _ in range(2):
        state, metrics = step(state, s.tpack, None, forced=FORCED)
        grads.append(metrics["_grads"])
    return grads


@pytest.fixture(scope="module")
def float64_steps(setup):
    """The reference of the gradient checks (module docstring)."""
    return port_steps(setup, torch.float64)


# the gradient bound against the float64 steps (module docstring)
GRAD_REL, GRAD_NOISE, GRAD_ELEM = 4e-3, 4.0, 0.25


def gradient_misses(port, jax_, ref):
    """Each tensor in which the port's or the JAX float32 gradient departs
    from the float64 gradient `ref` past the bound of the module
    docstring, as a line saying whose, which and by how much."""
    misses = []
    for name, r in ref.items():
        r = r.double()
        d_p = port[name].double() - r
        d_j = jax_[name].double() - r
        norm = r.norm().item()
        rms = norm / r.numel() ** 0.5
        for who, d, other in (("JAX", d_j, d_p), ("port", d_p, d_j)):
            err = d.norm().item()
            bound = GRAD_REL * norm + GRAD_NOISE * other.norm().item()
            if err > bound:
                misses.append(f"{who} {name}: |d|_2 {err:.4e} > {bound:.4e}")
                continue
            excess = (d.abs() - GRAD_NOISE * other.abs()).max().item()
            if excess > GRAD_ELEM * rms:
                misses.append(f"{who} {name}: an element {excess:.4e} past "
                              f"4 |d_other| > {GRAD_ELEM * rms:.4e}")
    return misses


def trunk_relu_inputs_jax(trunk_params, img):
    """Every ReLU input of the JAX ResNet-50 trunk on (B, H, W, 3) images,
    by the port's module names, NHWC."""
    inter = jax.jit(lambda p, x: ResNet(RESNET_LAYERS["resnet50"]).apply(
        {"params": p}, x, capture_intermediates=True)[1])(
            trunk_params, jnp.asarray(img))["intermediates"]
    out = {"bn1": inter["bn1"]["__call__"][0]}
    for stage, n in enumerate(RESNET_LAYERS["resnet50"], 1):
        for i in range(n):
            blk = inter[f"layer{stage}_{i}"]
            res = (blk["downsample_bn"]["__call__"][0] if i == 0 else
                   inter[f"layer{stage}_{i - 1}"]["__call__"][0])
            out[f"layer{stage}.{i}.bn1"] = blk["bn1"]["__call__"][0]
            out[f"layer{stage}.{i}.bn2"] = blk["bn2"]["__call__"][0]
            out[f"layer{stage}.{i}.bn3+residual"] = (
                blk["bn3"]["__call__"][0] + res)
    return {k: np.asarray(v) for k, v in out.items()}


def trunk_relu_inputs_port(body, img):
    """The same for the port's trunk (`backbone.0.body`), NHWC."""
    got, hooks = {}, []

    def keep(name):
        return lambda mod, args, out: got.__setitem__(name, out)

    for name, mod in body.named_modules():
        if name.endswith(("bn1", "bn2", "bn3", "downsample")) or (
                name.count(".") == 1 and name.startswith("layer")):
            hooks.append(mod.register_forward_hook(keep(name)))
    with torch.no_grad():
        body(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
    for h in hooks:
        h.remove()
    out = {"bn1": got["bn1"]}
    for stage, n in enumerate(RESNET_LAYERS["resnet50"], 1):
        for i in range(n):
            blk = f"layer{stage}.{i}"
            res = got[f"{blk}.downsample"] if i == 0 else \
                got[f"layer{stage}.{i - 1}"]
            out[f"{blk}.bn1"] = got[f"{blk}.bn1"]
            out[f"{blk}.bn2"] = got[f"{blk}.bn2"]
            out[f"{blk}.bn3+residual"] = got[f"{blk}.bn3"] + res
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in out.items()}


def trunk_sign_flips(s, steps):
    """Each ReLU input of the trunk whose sign differs between the two
    frameworks, on both frames, with the weights each step starts from
    (the start, then JAX's weights after step 0): (step, frame, ReLU after,
    (image, row, column, channel), JAX value, port value)."""
    model = build_model(s.cfg, "cpu", train=True)[0]
    body = model.backbone[0].body
    flips = []
    for step, params in enumerate([s.params, steps[0]["params"]]):
        model.load_state_dict(jax_params_to_state_dict(params))
        trunk = params["params"]["backbone"]["trunk"]
        for frame, (img, _, _) in enumerate(s.packs):
            want = trunk_relu_inputs_jax(trunk, img)
            got = trunk_relu_inputs_port(body, img)
            for name, j in want.items():
                t = got[name]
                for idx in zip(*np.nonzero((j > 0) != (t > 0))):
                    flips.append((step, frame, name,
                                  tuple(int(v) for v in idx),
                                  float(j[idx]), float(t[idx])))
    return flips


def test_trunk_relus_keep_their_sign(setup, jax_two_steps):
    """The fixture's draw puts no ReLU input of the trunk on different
    sides of 0 in the two frameworks at either step; where one did, every
    trunk gradient upstream of it would part (module docstring)."""
    assert trunk_sign_flips(setup, jax_two_steps[0]) == []


def port_two_steps_match(s, jax_steps, ref_grads):
    """Two steps of the port's train step from the same weights, held
    against the JAX steps, the gradients through the float64 steps
    `ref_grads` (module docstring)."""
    steps, jbefore = jax_steps
    s.tmodel.load_state_dict(jax_params_to_state_dict(s.params))
    optimizer = make_optimizer(s.cfg, s.tmodel, lr_drop_steps=LR_DROP_STEP)
    state = TrainState.create(s.tmodel, optimizer)
    step = make_train_step(s.tmodel, s.tcrit, optimizer, s.ttrack,
                           tracking=True, return_grads=True)
    start = {k: v.detach().clone()
             for k, v in train_tensors(s.tmodel).items()}
    before = start

    for it, jax_step in enumerate(steps):
        jmetrics, jgrads, jafter = (jax_step["metrics"], jax_step["grads"],
                                    jax_step["after"])
        state, metrics = step(state, s.tpack, None, forced=FORCED)
        assert state.step == it + 1 == jax_step["step"]

        assert set(metrics) - {"_grads"} == set(jmetrics)
        assert set(s.tcrit.weight_dict) <= set(metrics)
        for key, want in jmetrics.items():
            np.testing.assert_allclose(
                float(metrics[key]), float(want), rtol=1e-4, atol=1e-4,
                err_msg=f"step {it} {key}")

        grads = metrics["_grads"]
        assert set(grads) == set(jgrads) == set(ref_grads[it])
        misses = gradient_misses(grads, jgrads, ref_grads[it])
        assert misses == [], f"step {it} gradients: {misses[:5]}"

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
    # the learning rate dropped between the steps (after any warmup)
    warm = optimizer.warmup_steps
    ramp = [min(1.0, (i + 1) / warm) if warm else 1.0 for i in range(2)]
    assert optimizer.lr_scale(0) == ramp[0]
    assert optimizer.lr_scale(1) == pytest.approx(0.1 * ramp[1])


def test_two_train_steps_match_jax(setup, jax_two_steps, float64_steps):
    port_two_steps_match(setup, jax_two_steps, float64_steps)


def test_float64_bound_rejects_a_planted_fault(setup, jax_two_steps,
                                               float64_steps):
    """The gradient bound is not a formality: one gradient tensor scaled
    by 1.01 in both of the port's steps (a fault in its code) or in its
    float32 step alone (a fault of its float32 arithmetic) is rejected at
    both steps, and only that tensor is."""
    ported = port_steps(setup, torch.float32)
    name = "transformer.encoder.layers.0.linear2.weight"
    for it, jax_step in enumerate(jax_two_steps[0]):
        jgrads, ref = jax_step["grads"], float64_steps[it]
        assert gradient_misses(ported[it], jgrads, ref) == []
        scaled = {**ported[it], name: ported[it][name] * 1.01}
        both = gradient_misses(scaled, jgrads,
                               {**ref, name: ref[name] * 1.01})
        assert [m.split(":")[0] for m in both] == [f"JAX {name}"], both
        alone = gradient_misses(scaled, jgrads, ref)
        assert [m.split(":")[0] for m in alone] == [f"port {name}"], alone


@pytest.mark.parametrize("route", ["v4", "dec_skip"])
def test_two_train_steps_match_jax_on_route(setup, jax_two_steps,
                                            float64_steps, route,
                                            monkeypatch):
    """The same two steps with the port's MSDA calls on route "v4" (the
    encoder's 128 tokens on 4 levels; the decoder's calls stay on the
    default route) or under `MSDA_DEC_SKIP` (calls with few queries: the
    decoder's on 8 levels and, at this size, the encoder's), forward and
    backward: same tolerances, the JAX steps and the float64 reference on
    their default route."""
    from trackformer_tpu_torch.ops import msda, msda_dense
    monkeypatch.setattr(msda, "DENSE_CELL_BUDGET", 0)
    if route == "v4":
        monkeypatch.setattr(msda, "PALLAS_SKIP_IMPL", "v4")
        monkeypatch.setattr(msda, "PALLAS_V2_MIN_QUERIES", 100)
    else:
        monkeypatch.setattr(msda, "MSDA_DEC_SKIP", True)
        monkeypatch.setattr(msda, "PALLAS_DENSE_MAX_CELLS", 0)
    queries = []
    real = msda_dense.dense_level_pallas_v4p

    def noting(*a):
        queries.append(a[1].shape[1])
        return real(*a)
    monkeypatch.setattr(msda_dense, "dense_level_pallas_v4p", noting)
    port_two_steps_match(setup, jax_two_steps, float64_steps)
    # per step two forwards of 1 encoder layer x 2 frames x 4 levels
    assert queries.count(128) == 2 * 2 * 2 * 4
    assert (set(queries) == {128}) == (route == "v4")


def test_detection_step_and_bf16_master_weights(setup):
    """`tracking=False` takes a plain detection step; a bfloat16 model
    trains through float32 master weights that the model's parameters are
    the cast copy of; the TPU-fast mode builds for training."""
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
    # the TPU-fast mode trains too (tests/test_torch_fast_train.py)
    fast = build_model(FlagshipConfig.tpu_fast(**TINY), "cpu", train=True)
    assert len(fast) == 4 and fast[0].training


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


if __name__ == "__main__":
    # the sign flips of the trunk's ReLU inputs for a draw of the pack
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else PACK_SEED
    fixture = make_setup(seed)
    found = trunk_sign_flips(fixture, jax_steps(fixture)[0])
    print(f"pack seed {seed}: {len(found)} sign flip(s)")
    for step, frame, name, idx, j, t in found:
        print(f"step {step} frame {frame} ReLU after {name} at (image, "
              f"row, column, channel) {idx}: JAX {j!r}, port {t!r}")
