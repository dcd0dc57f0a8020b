"""The port's three-frame track-query training held against the JAX
package's train step on the CPU at the scale of `test_torch_train_step.py`
(its tiny flagship from one JAX init: 1 + 1 layers, hidden 96, 4 heads, 8
queries, 64x96 frames, float32, dropout 0):

  * three frames (`track_prev_prev_frame`): the previous-previous frame's
    forward, its match, the previous frame's track queries (no false
    positives) and its forward over the previous-previous features, then
    the current frame; against the port's own step in float64 by the
    gradient rule of `test_torch_train_step.py` (`gradient_misses`), the
    losses and `grad_norm` within 1e-4 (`backprop_prev_frame` on the same
    step: `test_torch_backprop.py`);
  * with `backprop_prev_frame` the gradient reaches the parameters through
    the previous frames too;
  * the MOT dataset's previous-previous frames (mirrored about the
    previous frame) bit for bit against the JAX dataset, and the
    `Loader`'s packs with the `prev_prev_*` keys equal to the JAX
    `Loader`'s (the COCO dataset's: `test_torch_train_data.py`);
  * `cli.train track_prev_prev_frame=true track_backprop_prev_frame=true`
    trains a debug epoch.

The track-query draws of both augmentations are pinned on both sides
(`forced`, and under "prev" the previous frame's), because no
`torch.Generator` draw equals `jax.random`'s.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (NAMED, TINY, gradient_misses, jax_args,
                                   recording_optimizer, tiny_cfg)
from trackformer_tpu.engine import train_step as jtrain
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models import tracking as jtracking
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import Targets as JTargets
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch, Targets

sys.path.insert(0, str(Path(__file__).parent))

torch.set_num_threads(1)

B, T, H, W = 2, 5, 64, 96
FORCED = {"num": 2, "num_fps": 1,
          "order": np.tile(np.arange(T), (B, 1)),
          "fp_seed_pos": np.tile(np.arange(T), (B, 1))}
# the previous frame's track queries from the previous-previous frame
FORCED_PREV = {"num": 3, "order": np.tile(np.arange(T), (B, 1))}
FRAMES = ("prev_prev_", "prev_", "")


def make_packs(seed=1):
    """Three frames of B images with 3 and 2 objects drifting; one object
    of image 0 leaves before the current frame, so its track query there
    is a false positive."""
    rng = np.random.RandomState(seed)
    valid_hw = np.array([[60, 90]] * B, np.int32)
    centre = rng.uniform(0.25, 0.75, (B, T, 2))
    size = rng.uniform(0.1, 0.3, (B, T, 2))
    packs = []
    for frame in range(3):
        img = rng.randn(B, H, W, 3).astype(np.float32)
        boxes = np.concatenate(
            [centre + 0.02 * frame * rng.randn(B, T, 2), size], -1)
        valid = np.zeros((B, T), bool)
        valid[0, :3] = True
        valid[1, :2] = True
        ids = np.where(valid, np.arange(T)[None], -1).astype(np.int32)
        if frame == 2:
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
    for prefix, (img, valid_hw, tgt) in zip(FRAMES, packs):
        out[prefix + "batch"] = JFrameBatch.from_images(
            jnp.asarray(img), jnp.asarray(valid_hw))
        out[prefix + "targets"] = JTargets(
            **{k: jnp.asarray(v) for k, v in tgt.items()})
    return out


def torch_pack(packs):
    out = {}
    for prefix, (img, valid_hw, tgt) in zip(FRAMES, packs):
        out[prefix + "batch"] = FrameBatch.from_images(
            torch.from_numpy(img), torch.from_numpy(valid_hw))
        out[prefix + "targets"] = Targets(
            **{k: torch.from_numpy(v) for k, v in tgt.items()})
    return out


@pytest.fixture(scope="module")
def setup():
    """The JAX tiny flagship's weights from one jitted init (perturbed as
    `test_torch_train_step.make_setup` perturbs them), its criterion and
    tracking configs, and the packs."""
    args = jax_args(NAMED, TINY)
    jmodel, jcrit, _, jtrack = jax_build_model(args)
    packs = make_packs()
    jpack = jax_pack(packs)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jpack["batch"])
    params = jax.tree.map(np.asarray, params)
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    return dict(args=args, jmodel=jmodel, jcrit=jcrit, jtrack=jtrack,
                params=params, jpack=jpack, tpack=torch_pack(packs))


def jax_step(s, backprop: bool):
    """One JAX three-frame train step with the pinned draws -> (metrics,
    gradients in the port's names)."""
    real = jtracking.add_track_queries_to_targets

    def pinned(*a, **kw):
        forced = FORCED_PREV if kw.get("add_false_pos") is False else FORCED
        return real(*a, **{**kw, "forced": forced})

    jtrack = s["jtrack"].replace(backprop_prev_frame=backprop)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracking, "add_track_queries_to_targets", pinned)
        opt = recording_optimizer(jtrain.make_optimizer(s["args"],
                                                        s["params"]))
        state = jtrain.TrainState.create(s["params"], opt)
        step = jax.jit(jtrain.make_train_step(
            s["jmodel"], s["jcrit"], opt, jtrack, tracking=True,
            prev_prev=True))
        state, metrics = step(state, s["jpack"], jax.random.PRNGKey(0))
        return ({k: float(v) for k, v in metrics.items()},
                jax_params_to_state_dict(jax.tree.map(np.asarray,
                                                      state.opt_state[0])))


def port_step(s, backprop: bool, dtype=torch.float32):
    """The port's three-frame step from the same weights and draws, its
    model in `dtype` on the CPU -> (metrics, float32 gradients)."""
    cfg = tiny_cfg()
    model, crit, _, track = build_model(cfg, "cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(s["params"]))
    model.to(dtype)
    track = dataclasses.replace(track, backprop_prev_frame=backprop)
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, crit, optimizer, track, tracking=True,
                           return_grads=True, prev_prev=True)
    _, metrics = step(state, s["tpack"], None,
                      forced={**FORCED, "prev": FORCED_PREV})
    grads = metrics.pop("_grads")
    return {k: float(v) for k, v in metrics.items()}, grads


def test_three_frame_step_matches_jax(setup):
    jmetrics, jgrads = jax_step(setup, False)
    metrics, grads = port_step(setup, False)
    _, ref = port_step(setup, False, torch.float64)
    assert set(metrics) == set(jmetrics)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(metrics[key], want, rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert set(grads) == set(jgrads) == set(ref)
    misses = gradient_misses(grads, jgrads, ref)
    assert misses == [], misses[:5]


def relative_changes(a, b):
    """|a - b|_2 / |b|_2 per tensor of two gradient dicts."""
    return {k: ((a[k].double() - b[k].double()).norm()
                / b[k].double().norm().clamp(min=1e-30)).item() for k in b}


def test_backprop_reaches_the_previous_frames(setup):
    """With `backprop_prev_frame` the gradient also flows back through the
    previous frames' forwards: the tensors that the current frame reaches
    by itself too (the trunk, the encoder, the decoder, the heads) get
    more of it, and the loss is the same."""
    stopped, g_stopped = port_step(setup, False)
    through, g_through = port_step(setup, True)
    assert stopped["loss"] == through["loss"]
    moved = {k for k, v in relative_changes(g_through, g_stopped).items()
             if v > 1e-2}
    assert len(moved) > 20
    assert any(k.startswith("backbone.") for k in moved)
    assert any(k.startswith("transformer.encoder.") for k in moved)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from synth_data import make_synth_mot
    return make_synth_mot(tmp_path_factory.mktemp("ppmot"), n_seqs=2,
                          n_frames=6)


def test_mot_prev_prev_samples_and_loader_match_jax(synth_root):
    """Items with their previous frame and the frame mirrored about it
    (clipped to the sequence), from the same global seed; the `Loader`'s
    packs (weighted sampling, prefetch) bit for bit the JAX `Loader`'s."""
    from test_torch_train_data import (BUCKETS, MAX_OBJECTS, assert_same,
                                       numpy_pack, train_args)
    from trackformer_tpu.cli.train import Loader as JLoader
    from trackformer_tpu.datasets import builder as jbuilder
    from trackformer_tpu.datasets import mot as jmot
    from trackformer_tpu_torch.cli.train import Loader
    from trackformer_tpu_torch.datasets import builder, mot

    args = train_args(synth_root, track_prev_prev_frame=True)
    port_ds, jax_ds = mot.build_mot("train", args), jmot.build_mot(
        "train", args)
    order = [0, 5, 11, 6, 3, 8]
    np.random.seed(5)
    got = [port_ds[i] for i in order]
    np.random.seed(5)
    want = [jax_ds[i] for i in order]
    for g, w in zip(got, want):
        assert set(g) == {"image", "target", "prev_image", "prev_target",
                          "prev_prev_image", "prev_prev_target"}
        assert_same(g, w)
        cur, prev, pp = (int(g[k]["image_id"]) for k in (
            "target", "prev_target", "prev_prev_target"))
        assert cur // 6 == prev // 6 == pp // 6
        assert pp == min(max(cur // 6 * 6, 2 * prev - cur), cur // 6 * 6 + 5)

    def run(loader_cls, ds, collate):
        np.random.seed(11)
        loader = loader_cls(ds, 2, collate, shuffle=True,
                            weights=ds.sample_weights, seed=4, prefetch=2)
        return [numpy_pack(p) for p in loader]

    packs = run(Loader, port_ds, lambda s: builder.collate_fn(
        s, BUCKETS, MAX_OBJECTS))
    jpacks = run(JLoader, jax_ds, lambda s: jbuilder.collate_fn(
        s, BUCKETS, MAX_OBJECTS))
    assert len(packs) == len(jpacks) == 6
    for g, w in zip(packs, jpacks):
        assert set(g) == {"batch", "targets", "prev_batch", "prev_targets",
                          "prev_prev_batch", "prev_prev_targets"}
        assert_same(g, w)


def test_train_cli_three_frames_with_backprop(synth_root, tmp_path):
    from test_torch_train_cli import TINY as CLI_TINY
    from trackformer_tpu_torch.cli.train import main
    argv = ["with", *CLI_TINY, "dataset=mot", f"mot_path_train={synth_root}",
            f"mot_path_val={synth_root}", "train_split=synth_train",
            "val_split=synth_train", "tracking_eval=false", "debug=true",
            "epochs=1", "track_prev_prev_frame=true",
            "track_backprop_prev_frame=true", "tpu.remat=true",
            f"output_dir={tmp_path}"]
    state = main(argv, device="cpu")
    assert state.step == 2
    assert (tmp_path / "checkpoint.pt").exists()
