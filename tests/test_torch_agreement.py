"""The port's agreement tools (`trackformer_tpu_torch/tools/
fast_exact_agreement.py`, `tracking_agreement.py`) held against the JAX
package's (`tools/fast_exact_agreement.py`, `tools/tracking_agreement.py`)
on the CPU:

  * the scenes and sequences of every scale, bit for bit;
  * `eval_map`, the cross-agreement AP and the tracking `score` on the same
    seeded predictions and tracks, equal to the JAX tools' numbers;
  * the targets each tool builds from the same boxes;
  * three `small`-scale detection steps of the exact arm from the same
    weights (a JAX init carried over by `convert.py`) on the same batches
    in the same order: the loss trajectories. Float32 on both sides, summed
    in different orders; Adam moves an element whose gradient is near zero
    by up to a learning rate either way, so the later losses part a
    little: 2e-3 relative at each step (the first step's loss, before any
    update, agrees to 1e-4).

The JAX tools read their scale from the command line at import, so each
is loaded with the command line it would be run with.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu_torch.tools import fast_exact_agreement as port_det
from trackformer_tpu_torch.tools import tracking_agreement as port_track

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def load_jax_tool(name, *argv):
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}_{'_'.join(argv)}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


@pytest.mark.parametrize("scale", ["small", "mid", "flagship"])
def test_scenes_are_the_jax_tools(scale):
    jtool = load_jax_tool("fast_exact_agreement", "10", scale)
    sc = port_det.SCALES[scale]
    assert (sc.h, sc.w, sc.n_train, sc.n_eval, sc.batch, sc.max_obj) == (
        jtool.H, jtool.W, jtool.N_TRAIN, jtool.N_EVAL, jtool.BATCH,
        jtool.MAX_OBJ)
    assert sc.model == jtool.MODEL_OVER
    rng = np.random.RandomState(0)
    want = [jtool.make_scene(rng) for _ in range(jtool.N_TRAIN
                                                  + jtool.N_EVAL)]
    train, held_out = port_det.make_scenes(sc)
    for (img, boxes), (jimg, jboxes) in zip(train + held_out, want):
        assert np.array_equal(img, jimg) and np.array_equal(boxes, jboxes)
    for mode in ("exact", "fast", "fast_w8", "exact_f32_remat0",
                 "fast_w16", "fast_w16_f32"):
        assert port_det.mode_over(mode) == jtool._mode_over(mode)
    with pytest.raises(NotImplementedError, match="window side"):
        port_det.mode_over("fast_w12")
    with pytest.raises(ValueError):
        port_det.mode_over("fast_x")


@pytest.mark.parametrize("scale", ["small", "mid"])
def test_sequences_are_the_jax_tools(scale):
    jtool = load_jax_tool("tracking_agreement", "10", scale)
    sc = port_track.SCALES[scale]
    assert sc.model == jtool.MODEL_OVER and sc.max_obj == jtool.MAX_OBJ
    rng = np.random.RandomState(0)
    want = [jtool.make_sequence(rng)
            for _ in range(jtool.N_SEQ + jtool.N_EVAL_SEQ)]
    train, held_out = port_track.make_sequences(sc)
    for (frames, gts), (jframes, jgts) in zip(train + held_out, want):
        assert np.array_equal(frames, jframes)
        assert len(gts) == len(jgts)
        for g, jg in zip(gts, jgts):
            assert g.keys() == jg.keys()
            for k in g:
                assert np.array_equal(g[k], jg[k])
    # the targets of one batch, as each tool builds them
    gts = [gt for s in train[:2] for gt in s[1][:2]]
    tt = port_track.gts_to_targets(gts, sc, "cpu")
    jt = jtool.gts_to_targets(gts)
    for name in ("valid", "labels", "boxes", "track_ids"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)


def test_detection_targets_are_the_jax_tools():
    jtool = load_jax_tool("fast_exact_agreement", "10", "small")
    sc = port_det.SCALES["small"]
    train, _ = port_det.make_scenes(sc)
    boxes = [s[1] for s in train[:5]]
    tt = port_det.to_targets(boxes, sc, "cpu")
    jt = jtool.to_targets(boxes)
    for name in ("valid", "labels", "boxes"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)


def seeded_predictions(n_img, sc, seed):
    """Boxes near the held-out rectangles with scores, some relabelled to
    the background column: predictions both evaluators score alike."""
    rng = np.random.RandomState(seed)
    _, held_out = port_det.make_scenes(sc)
    preds = {}
    for i, (_, boxes) in enumerate(held_out[:n_img]):
        q = 12
        xyxy = np.zeros((q, 4), np.float32)
        for j in range(q):
            x, y, w, h = boxes[j % len(boxes)]
            jit = rng.normal(0, 3, 4)
            xyxy[j] = [x + jit[0], y + jit[1], x + w + jit[2], y + h + jit[3]]
        preds[i] = {"boxes": xyxy,
                    "scores": rng.uniform(0.2, 1.0, q).astype(np.float32),
                    "labels": (rng.rand(q) < 0.2).astype(np.int64)}
    return preds


def test_eval_map_and_cross_agreement_are_the_jax_tools():
    jtool = load_jax_tool("fast_exact_agreement", "10", "small")
    sc = port_det.SCALES["small"]
    _, held_out = port_det.make_scenes(sc)
    gt = port_det.boxes_to_anns(held_out)
    assert gt == jtool.boxes_to_anns(held_out)
    a = seeded_predictions(len(held_out), sc, 1)
    b = seeded_predictions(len(held_out), sc, 2)
    got = port_det.eval_map(a, gt, sc)
    assert got == jtool.eval_map(a, gt)
    assert got[0] > 0.1
    pseudo = port_det.preds_to_anns(b)
    assert pseudo == jtool.preds_to_anns(b)
    assert port_det.eval_map(a, pseudo, sc) == jtool.eval_map(a, pseudo)


def seeded_tracks(gts_per_seq, seed):
    """Tracker-style results near the true tracks: jittered boxes, one
    identity switch and a dropped frame per sequence."""
    rng = np.random.RandomState(seed)
    out = []
    for gts in gts_per_seq:
        res = {}
        for f, gt in enumerate(gts):
            for tid, box in gt.items():
                if (f + tid) % 5 == 3:
                    continue
                out_id = tid + (10 if f > len(gts) // 2 and tid == 0 else 0)
                res.setdefault(out_id, {})[f] = {
                    "bbox": (box + rng.normal(0, 2, 4)).astype(np.float32),
                    "score": 0.9, "obj_ind": 0}
        out.append(res)
    return out


def test_score_is_the_jax_tools():
    jtool = load_jax_tool("tracking_agreement", "10", "small")
    sc = port_track.SCALES["small"]
    _, held_out = port_track.make_sequences(sc)
    gts = [s[1] for s in held_out]
    a, b = seeded_tracks(gts, 1), seeded_tracks(gts, 2)
    got = port_track.score(a, gts, "a")
    assert got == jtool.score(a, gts, "a")
    assert 0.2 < got[0] < 1.0 and 0.2 < got[1] < 1.0
    pseudo = port_track.results_as_gts(b, sc.t)
    jpseudo = jtool.results_as_gts(b, sc.t)
    assert port_track.score(a, pseudo, "x") == jtool.score(a, jpseudo, "x")


def test_small_detection_steps_match_jax():
    """The exact arm's first three `small` steps in both packages from the
    same weights and batches (module docstring)."""
    from trackformer_tpu.engine import (TrainState as JState,
                                        make_optimizer as jmake_optimizer,
                                        make_train_step as jmake_step)
    from trackformer_tpu.models import build_model as jbuild
    from trackformer_tpu.structures import FrameBatch as JFrameBatch
    from trackformer_tpu.utils.config import nested_namespace
    from trackformer_tpu_torch.convert import jax_params_to_state_dict
    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.structures import FrameBatch
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    steps, n = 350, 3
    jtool = load_jax_tool("fast_exact_agreement", str(steps), "small")
    sc = port_det.SCALES["small"]
    cfg, opt_cfg = port_det.train_config("exact", sc, steps)
    args = nested_namespace(cfg)
    args.lr_drop_steps = opt_cfg["lr_drop_steps"]
    jmodel, jcrit, _, _ = jbuild(args)
    train, _ = port_det.make_scenes(sc)
    sizes = np.array([[sc.h, sc.w]] * sc.batch)
    imgs = np.stack([s[0] for s in train])
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0),
        JFrameBatch.from_images(jnp.asarray(imgs[:sc.batch]),
                                jnp.asarray(sizes)))
    params = jax.tree.map(np.asarray, params)
    jopt = jmake_optimizer(args, params)
    jstate = JState.create(params, jopt)
    jstep = jax.jit(jmake_step(jmodel, jcrit, jopt, tracking=False))

    model_cfg = FlagshipConfig.from_config(cfg)
    model, crit, _, _ = build_model(model_cfg, "cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(params))
    opt = make_optimizer(model_cfg, model,
                         lr_drop_steps=opt_cfg["lr_drop_steps"])
    state = TrainState.create(model, opt)
    step = make_train_step(model, crit, opt, tracking=False)

    jtargets_all = jtool.to_targets([s[1] for s in train])
    targets_all = port_det.to_targets([s[1] for s in train], sc, "cpu")
    order = np.random.RandomState(1)
    jlosses, losses = [], []
    for it in range(n):
        idx = order.choice(len(train), sc.batch, replace=False)
        jpack = {"batch": JFrameBatch.from_images(jnp.asarray(imgs[idx]),
                                                  jnp.asarray(sizes)),
                 "targets": jax.tree.map(lambda x: x[idx], jtargets_all)}
        jstate, jm = jstep(jstate, jpack, jax.random.PRNGKey(it))
        jlosses.append(float(jm["loss"]))
        ti = torch.as_tensor(idx)
        pack = {"batch": FrameBatch.from_images(
            torch.from_numpy(imgs[idx]), torch.from_numpy(sizes)),
            "targets": port_det.take_rows(targets_all, ti)}
        state, m = step(state, pack, None)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3)
    assert losses[-1] < losses[0]
