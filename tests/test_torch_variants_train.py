"""One training step of the single-frame Deformable DETR family
(`train.yaml` + `deformable tracking`, multi-frame attention off) held
against the JAX package on the CPU, in each of `tracking=False`
(detection) and `tracking=True` (two-frame track queries on the
single-frame model: the previous frame's forward, the match, the
augmentation), from the same weights on the same seeded pack, the
track-query draws pinned on both sides. The weights are a JAX init at
`PRNGKey(0)` with the heads and offsets perturbed, as in
`test_torch_train_step.make_setup`: flax draws each parameter from its
path, so the trunk is that test's, on which its pack (seed 1) puts no
ReLU input of the trunk within float32 noise of zero (a kink there
moves every trunk gradient upstream in one framework only).

Tolerances as in `test_torch_train_step.py`: every loss key, the total and
`grad_norm` to 1e-4 relative; the gradients, name by name, held against the
port's own step in float64 from the same weights with the same draws
(`gradient_misses`: |d_jax|_2 <= 4e-3 |r|_2 + 4 |d_port|_2 and the same
swapped, per element 0.25 rms(r) over 4 |d_other|).
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_train_step import (FORCED, gradient_misses, jax_args,
                                   jax_pack, make_pack, recording_optimizer,
                                   torch_pack)
from trackformer_tpu.engine import train_step as jtrain
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models import tracking as jtracking
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.utils.config import FlagshipConfig, load_config

torch.set_num_threads(1)

SINGLE = ["deformable", "tracking"]
TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8, "dropout": 0.0}


def port_cfg() -> FlagshipConfig:
    return FlagshipConfig.from_config(load_config(
        "train.yaml", SINGLE, {**TINY, "tpu.compute_dtype": "float32"}))


@pytest.fixture(scope="module")
def setup():
    args = jax_args(SINGLE, TINY)
    jmodel, jcrit, _, jtrack = jax_build_model(args)
    packs = make_pack()
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jax_pack(packs)["batch"]))
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    return args, jmodel, jcrit, jtrack, params, packs


def jax_step(setup, tracking):
    args, jmodel, jcrit, jtrack, params, packs = setup
    pack = jax_pack(packs)
    if not tracking:
        pack = {"batch": pack["batch"], "targets": pack["targets"]}
    real = jtracking.add_track_queries_to_targets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracking, "add_track_queries_to_targets",
                   lambda *a, **kw: real(*a, **{**kw, "forced": FORCED}))
        opt = recording_optimizer(jtrain.make_optimizer(args, params))
        state = jtrain.TrainState.create(params, opt)
        step = jax.jit(jtrain.make_train_step(jmodel, jcrit, opt, jtrack,
                                              tracking=tracking))
        state, metrics = step(state, pack, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            jax_params_to_state_dict(jax.tree.map(np.asarray,
                                                  state.opt_state[0])))


def port_step(setup, tracking, dtype):
    params, packs = setup[4], setup[5]
    cfg = port_cfg()
    model, crit, _, track = build_model(cfg, "cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(params))
    model.to(dtype)
    opt = make_optimizer(cfg, model, lr_drop_steps=1)
    state = TrainState.create(model, opt)
    step = make_train_step(model, crit, opt, track, tracking=tracking,
                           return_grads=True)
    pack = torch_pack(packs)
    if not tracking:
        pack = {"batch": pack["batch"], "targets": pack["targets"]}
    _, metrics = step(state, pack, None, forced=FORCED)
    return metrics


@pytest.mark.parametrize("tracking", [False, True],
                         ids=["detection", "tracking"])
def test_single_frame_train_step_matches_jax(setup, tracking):
    jmetrics, jgrads = jax_step(setup, tracking)
    metrics = port_step(setup, tracking, torch.float32)
    ref = port_step(setup, tracking, torch.float64)["_grads"]
    assert set(metrics) - {"_grads"} == set(jmetrics)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    grads = metrics["_grads"]
    assert set(grads) == set(jgrads) == set(ref)
    # the shared heads of the single-frame model are one tensor each
    assert "class_embed.0.weight" in grads
    misses = gradient_misses(grads, jgrads, ref)
    assert misses == [], misses[:5]
