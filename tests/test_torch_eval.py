"""The port's evaluation (trackformer_tpu_torch.datasets.coco_eval, .utils.
mot_metrics, .utils.track_utils, .engine.loop.make_results / evaluate)
held against the JAX package's on the same inputs, on the CPU:

  * `CocoEvaluator`: the 12 box statistics within 1e-12 on the fixtures
    of tests/test_coco_eval.py and on 50 seeded random images with crowd
    and ignored ground truth in every area range; `segm` on seeded
    masks (keypoints: `test_torch_tools.py`), an unknown iou type
    refused;
  * `summarize` of `MOTAccumulator`s within 1e-12 on the cases of
    tests/test_mot_metrics.py and on seeded random sequences with
    switches, false positives and misses; `get_mot_accum` and
    `interpolate_tracks` on one results dict;
  * `make_results` on the same outputs: equal up to float32 rounding of
    the postprocess (1e-6 relative);
  * `evaluate` of a tiny exact model (float32, the same weights through
    `convert.py`) over two packs: the losses within 1e-4 + 1e-4 |ref|
    (the box losses of the planted matches are near 0, where float32
    noise is relative) and the 12 COCO statistics within 1e-6. The ground
    truth is planted on the port's own top detections, so that matches
    sit far from every IoU threshold and float32 noise between the
    frameworks cannot flip one.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.datasets import coco_eval as jcoco
from trackformer_tpu.engine import loop as jloop
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models.postprocess import \
    postprocess_sigmoid as jpostprocess
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import Targets as JTargets
from trackformer_tpu.utils import mot_metrics as jmot
from trackformer_tpu.utils import track_utils as jtrack
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.datasets import coco_eval
from trackformer_tpu_torch.engine import loop
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.models.postprocess import postprocess_sigmoid
from trackformer_tpu_torch.structures import FrameBatch, Targets
from trackformer_tpu_torch.utils import mot_metrics, track_utils
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)


class FakeGT:
    def __init__(self, anns_by_image):
        self.anns_by_image = anns_by_image


def ann(x, y, w, h, cat=1, crowd=0, ignore=0):
    return {"bbox": [x, y, w, h], "category_id": cat, "iscrowd": crowd,
            "ignore": ignore, "area": w * h}


def fixture_cases():
    """(ground truth, predictions) of tests/test_coco_eval.py."""
    one = {"boxes": np.array([[0, 0, 10, 10]], np.float64),
           "scores": np.array([1.0]), "labels": np.array([1])}
    return [
        ({1: [ann(0, 0, 10, 10), ann(50, 50, 10, 10)]},
         {1: {"boxes": np.array([[0, 0, 10, 10], [100, 100, 110, 110],
                                 [50, 50, 60, 60]], np.float64),
              "scores": np.array([0.9, 0.8, 0.7]),
              "labels": np.array([1, 1, 1])}}),
        ({1: [ann(0, 0, 10, 10)]}, {1: one}),
        ({1: [ann(0, 0, 10, 10), ann(50, 50, 10, 10, ignore=1)]},
         {1: {"boxes": np.array([[0, 0, 10, 10], [50, 50, 60, 60]],
                                np.float64),
              "scores": np.array([0.9, 0.8]), "labels": np.array([1, 1])}}),
        ({1: [ann(0, 0, 10, 10)]},
         {1: {"boxes": np.array([[0, 0, 10, 8.1]], np.float64),
              "scores": np.array([0.9]), "labels": np.array([1])}}),
    ]


def random_case(seed=0, n_images=50, n_cats=3):
    """Images with 0-7 ground-truth boxes of every area range (sides 4 to
    200 pixels), some crowd, some ignored; detections near them (jittered,
    with their categories sometimes wrong) and false positives, with
    random scores."""
    rng = np.random.RandomState(seed)
    gts, preds = {}, {}
    for img in range(1, n_images + 1):
        anns, boxes, scores, labels = [], [], [], []
        for _ in range(rng.randint(0, 8)):
            w, h = np.exp(rng.uniform(np.log(4), np.log(200), 2))
            x, y = rng.uniform(0, 400, 2)
            cat = int(rng.randint(1, n_cats + 1))
            anns.append(ann(x, y, w, h, cat, crowd=int(rng.rand() < 0.1),
                            ignore=int(rng.rand() < 0.1)))
            if rng.rand() < 0.8:
                j = rng.normal(0, 0.15, 4) * [w, h, w, h]
                boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
                scores.append(rng.rand())
                labels.append(cat if rng.rand() < 0.9
                              else int(rng.randint(1, n_cats + 1)))
        for _ in range(rng.randint(0, 4)):
            x, y = rng.uniform(0, 400, 2)
            w, h = np.exp(rng.uniform(np.log(4), np.log(200), 2))
            boxes.append([x, y, x + w, y + h])
            scores.append(rng.rand())
            labels.append(int(rng.randint(1, n_cats + 1)))
        gts[img] = anns
        preds[img] = {"boxes": np.array(boxes, np.float64).reshape(-1, 4),
                      "scores": np.array(scores), "labels": np.array(labels)}
    return gts, preds


def assert_stats_equal(got, want, tol):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   atol=tol, rtol=0, err_msg=key)


@pytest.mark.parametrize("case", list(range(4)) + ["random"])
def test_coco_evaluator_matches_jax(case, capsys):
    gts, preds = (random_case() if case == "random"
                  else fixture_cases()[case])
    ours = coco_eval.CocoEvaluator(FakeGT(gts))
    theirs = jcoco.CocoEvaluator(FakeGT(gts))
    for ev in (ours, theirs):
        ev.update(preds)
        ev.synchronize_between_processes()
    assert ours.prepare(preds, "bbox") == theirs.prepare(preds, "bbox")
    got, want = ours.summarize(), theirs.summarize()
    assert_stats_equal(got, want, 1e-12)
    if case == "random":
        stats = np.array(want["bbox"])
        # every statistic is exercised: no area range is empty
        assert np.isfinite(stats).all() and 0 < stats[0] < 1


def segm_case(seed=0, n_images=12, hw=(40, 60)):
    """Images with 0-4 ground-truth masks (rectangles, one in ten crowd),
    detected masks near them (shifted a pixel or two, as RLE dicts and as
    arrays) and false positives, with random scores."""
    from trackformer_tpu_torch.utils import rle
    rng = np.random.RandomState(seed)
    gts, preds = {}, {}
    for img in range(1, n_images + 1):
        anns, boxes, scores, labels, masks = [], [], [], [], []
        for _ in range(rng.randint(0, 5)):
            y0, x0 = rng.randint(0, hw[0] - 8), rng.randint(0, hw[1] - 8)
            h, w = rng.randint(4, hw[0] - y0), rng.randint(4, hw[1] - x0)
            m = np.zeros(hw, bool)
            m[y0:y0 + h, x0:x0 + w] = True
            anns.append({**ann(x0, y0, w, h, crowd=int(rng.rand() < 0.1)),
                         "area": int(m.sum()),
                         "segmentation": rle.encode_mask(m)})
            if rng.rand() < 0.8:
                d = np.roll(m, tuple(rng.randint(-2, 3, 2)), (0, 1))
                masks.append(rle.encode_mask(d) if rng.rand() < 0.5 else d)
                boxes.append([x0, y0, x0 + w, y0 + h])
                scores.append(rng.rand())
                labels.append(1)
        for _ in range(rng.randint(0, 3)):
            d = rng.rand(*hw) > 0.97
            masks.append(d)
            boxes.append([0, 0, 5, 5])
            scores.append(rng.rand())
            labels.append(1)
        gts[img] = anns
        preds[img] = {"boxes": np.array(boxes, np.float64).reshape(-1, 4),
                      "scores": np.array(scores), "labels": np.array(labels),
                      "masks": masks}
    return gts, preds


def test_coco_evaluator_refuses_masks_and_keypoints():
    """An unknown iou type is refused, `keypoints` taken (its statistics
    against JAX: `test_torch_tools.py`); `segm` (mask IoU, crowd ground
    truth, the masks' areas in the area ranges) gives the JAX evaluator's
    12 statistics of both iou types and its result list."""
    with pytest.raises(ValueError, match="Unknown iou type"):
        coco_eval.CocoEvaluator(FakeGT({}), ("bbox", "densepose"))
    coco_eval.CocoEvaluator(FakeGT({}), ("bbox", "keypoints"))
    gts, preds = segm_case()
    ours = coco_eval.CocoEvaluator(FakeGT(gts), ("bbox", "segm"))
    theirs = jcoco.CocoEvaluator(FakeGT(gts), ("bbox", "segm"))
    for ev in (ours, theirs):
        ev.update(preds)
    assert ours.prepare(preds, "segm") == theirs.prepare(preds, "segm")
    got, want = ours.summarize(), theirs.summarize()
    assert_stats_equal(got, want, 1e-12)
    assert 0 < want["segm"][0] < 1 and want["segm"] != want["bbox"]


def box(x, y, s=10):
    return np.array([x, y, x + s, y + s], np.float32)


def mot_cases():
    """Frames of tests/test_mot_metrics.py: perfect, a switch, a miss and
    a false positive, the carried-over pairing, mostly lost."""
    g1, g2 = box(0, 0), box(8, 0)
    return [
        [({1: box(0, 0)}, {5: box(0, 0)}) for _ in range(4)],
        [({1: box(0, 0)}, {5: box(0, 0)}), ({1: box(0, 0)}, {5: box(0, 0)}),
         ({1: box(0, 0)}, {6: box(0, 0)}), ({1: box(0, 0)}, {6: box(0, 0)})],
        [({1: box(0, 0)}, {}), ({1: box(0, 0)}, {5: box(0, 0)}),
         ({}, {5: box(0, 0)}), ({1: box(0, 0)}, {5: box(0, 0)})],
        [({1: g1, 2: g2}, {5: g1, 6: g2}),
         ({1: box(3, 0), 2: box(5, 0)}, {5: box(4, 0), 6: box(4, 0)})],
        [({1: box(0, 0)}, {})] * 9 + [({1: box(0, 0)}, {5: box(0, 0)})],
    ]


def random_sequence(seed, n_frames=30, n_objects=6):
    """Objects moving on straight lines, entering and leaving; the
    hypotheses follow them with jitter, now and then lose one, swap ids
    or add a false positive."""
    rng = np.random.RandomState(seed)
    start = rng.uniform(0, 300, (n_objects, 2))
    vel = rng.normal(0, 4, (n_objects, 2))
    size = rng.uniform(20, 60, n_objects)
    life = np.sort(rng.randint(0, n_frames, (n_objects, 2)), 1)
    hyp_id = np.arange(n_objects) + 100
    frames = []
    for f in range(n_frames):
        gt, hyp = {}, {}
        if rng.rand() < 0.1:
            a, b = rng.choice(n_objects, 2, replace=False)
            hyp_id[[a, b]] = hyp_id[[b, a]]
        for o in range(n_objects):
            if not life[o, 0] <= f <= life[o, 1]:
                continue
            xy = start[o] + vel[o] * f
            gt[o] = np.array([*xy, *(xy + size[o])], np.float32)
            if rng.rand() < 0.85:
                j = xy + rng.normal(0, 3, 2)
                hyp[int(hyp_id[o])] = np.array([*j, *(j + size[o])],
                                               np.float32)
        if rng.rand() < 0.3:
            xy = rng.uniform(0, 300, 2)
            hyp[999 + f] = np.array([*xy, *(xy + 30)], np.float32)
        frames.append((gt, hyp))
    return frames


def accumulate(module, frames, name):
    acc = module.MOTAccumulator(name)
    for gt, hyp in frames:
        gt_ids, hyp_ids = list(gt), list(hyp)
        dist = module.iou_distance(
            np.asarray([gt[i] for i in gt_ids]).reshape(-1, 4),
            np.asarray([hyp[i] for i in hyp_ids]).reshape(-1, 4))
        acc.update(gt_ids, hyp_ids, dist)
    return acc


def test_mot_summary_matches_jax():
    seqs = mot_cases() + [random_sequence(s) for s in range(4)]
    names = [f"seq{i}" for i in range(len(seqs))]
    got = mot_metrics.summarize(
        [accumulate(mot_metrics, f, n) for f, n in zip(seqs, names)])
    want = jmot.summarize(
        [accumulate(jmot, f, n) for f, n in zip(seqs, names)])
    assert set(got) == set(want) == set(names) | {"OVERALL"}
    for name in want:
        assert_stats_equal(got[name], want[name], 1e-12)
    overall = want["OVERALL"]
    assert overall["num_switches"] > 0 and overall["num_misses"] > 0
    assert overall["num_false_positives"] > 0
    assert mot_metrics.format_summary(got) == jmot.format_summary(want)


class FakeSequence:
    """What `get_mot_accum` reads of a sequence: its length, its name and
    each frame's ground truth."""

    def __init__(self, frames, name="synthetic"):
        self.data = [{"gt": gt} for gt, _ in frames]
        self.name = name

    def __len__(self):
        return len(self.data)

    def __str__(self):
        return self.name


def results_of(frames):
    """A tracker's results dict from hypothesis frames, every fourth frame
    left out (gaps inside the tracks to fill)."""
    results = {}
    for f, (_, hyp) in enumerate(frames):
        if f % 4 == 3:
            continue
        for tid, b in hyp.items():
            results.setdefault(tid, {})[f] = {
                "bbox": b, "score": 0.5 + 0.01 * (tid % 7)}
    return results


def test_get_mot_accum_and_interpolate_tracks_match_jax(capsys):
    frames = random_sequence(7)
    seq = FakeSequence(frames)
    results = results_of(frames)
    filled = track_utils.interpolate_tracks(results)
    jfilled = jtrack.interpolate_tracks(results)
    assert set(filled) == set(jfilled)
    assert sum(len(t) for t in filled.values()) > \
        sum(len(t) for t in results.values())
    for tid, track in jfilled.items():
        assert set(filled[tid]) == set(track)
        for f, d in track.items():
            assert np.array_equal(filled[tid][f]["bbox"], d["bbox"])
            assert filled[tid][f]["score"] == d["score"]
    for res in (results, filled):
        acc = track_utils.get_mot_accum(res, seq)
        jacc = jtrack.get_mot_accum(res, seq)
        assert acc.name == jacc.name == "synthetic"
        assert [e["matches"] for e in acc.events] == \
            [e["matches"] for e in jacc.events]
        got = track_utils.evaluate_mot_accums([acc], ["synthetic"])
        want = jtrack.evaluate_mot_accums([jacc], ["synthetic"])
        for name in want:
            assert_stats_equal(got[name], want[name], 1e-12)


def targets_of(rng, b, t, image_ids, boxes=None):
    """Padded targets as numpy: 2 objects an image, labels 0, the given
    normalized cxcywh boxes (else random), original sizes 120 x 180."""
    valid = np.zeros((b, t), bool)
    valid[:, :2] = True
    if boxes is None:
        boxes = np.concatenate([rng.uniform(0.25, 0.75, (b, t, 2)),
                                rng.uniform(0.1, 0.3, (b, t, 2))], -1)
    return dict(labels=np.zeros((b, t), np.int32),
                boxes=boxes.astype(np.float32), valid=valid,
                track_ids=np.where(valid, np.arange(t)[None], -1)
                .astype(np.int32),
                orig_size=np.tile([[120, 180]], (b, 1)).astype(np.int32),
                size=np.tile([[60, 90]], (b, 1)).astype(np.int32),
                image_id=np.asarray(image_ids, np.int32))


def test_make_results_matches_jax():
    """Outputs with 3 track-query slots in front of 8 object queries."""
    rng = np.random.RandomState(3)
    b, q, k, c = 2, 8, 3, 4
    logits = rng.randn(b, k + q, c).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, k + q, 2)),
                            rng.uniform(0.05, 0.3, (b, k + q, 2))],
                           -1).astype(np.float32)
    tgt = targets_of(rng, b, 4, [11, 42])
    got = loop.make_results(
        {"pred_logits": torch.from_numpy(logits),
         "pred_boxes": torch.from_numpy(boxes)},
        Targets(**{k_: torch.from_numpy(v) for k_, v in tgt.items()}),
        postprocess_sigmoid, q)
    want = jloop.make_results(
        {"pred_logits": jnp.asarray(logits), "pred_boxes": jnp.asarray(boxes)},
        JTargets(**{k_: jnp.asarray(v) for k_, v in tgt.items()}),
        jpostprocess, q)
    assert set(got) == set(want) == {11, 42}
    for img, res in want.items():
        assert set(got[img]) == set(res) == {"boxes", "scores", "labels"}
        assert got[img]["boxes"].shape == (q, 4)
        np.testing.assert_array_equal(got[img]["labels"], res["labels"])
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(got[img][key], res[key], rtol=1e-6,
                                       atol=1e-6)
    # with masks: each object query's mask at the padded 64x96 size,
    # cropped to 60x90 and resized to 120x180; equal wherever the
    # probability after the resize is not within 1e-4 of 0.5
    from PIL import Image

    from trackformer_tpu.models import segmentation as jsegm
    from trackformer_tpu_torch.models import segmentation as segm
    from trackformer_tpu_torch.utils import rle
    pred_masks = 4 * rng.randn(b, k + q, 16, 24).astype(np.float32)
    img = np.zeros((b, 64, 96, 3), np.float32)
    valid_hw = np.array([[60, 90]] * b, np.int32)
    got = loop.make_results(
        {"pred_logits": torch.from_numpy(logits),
         "pred_boxes": torch.from_numpy(boxes),
         "pred_masks": torch.from_numpy(pred_masks)},
        Targets(**{k_: torch.from_numpy(v) for k_, v in tgt.items()}),
        postprocess_sigmoid, q, postprocess_segm=segm.postprocess_segm,
        batch=FrameBatch.from_images(torch.from_numpy(img),
                                     torch.from_numpy(valid_hw)))
    jout = {"pred_logits": jnp.asarray(logits),
            "pred_boxes": jnp.asarray(boxes),
            "pred_masks": jnp.asarray(pred_masks)}
    want = jloop.make_results(
        jout, JTargets(**{k_: jnp.asarray(v) for k_, v in tgt.items()}),
        jpostprocess, q, postprocess_segm=jsegm.postprocess_segm,
        batch=JFrameBatch.from_images(jnp.asarray(img),
                                      jnp.asarray(valid_hw)))
    probs = np.asarray(jsegm.postprocess_segm({}, jout, (64, 96),
                                              return_probs=True)["masks"])
    for i, img_id in enumerate((11, 42)):
        assert len(got[img_id]["masks"]) == len(want[img_id]["masks"]) == q
        for j, (g, w) in enumerate(zip(got[img_id]["masks"],
                                       want[img_id]["masks"])):
            p = np.asarray(Image.fromarray(probs[i, k + j, :60, :90])
                           .resize((180, 120), Image.BILINEAR))
            sure = np.abs(p - 0.5) > 1e-4
            gm, wm = rle.decode_mask(g), rle.decode_mask(w)
            assert gm.shape == (120, 180)
            np.testing.assert_array_equal(gm[sure], wm[sure])


NAMED = ["deformable", "tracking", "multi_frame"]
TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8, "dropout": 0.0}
B, T, H, W = 2, 5, 64, 96


def test_evaluate_matches_jax(capsys):
    args = nested_namespace(load_config(
        "train.yaml", NAMED, {**TINY, "tpu.compute_dtype": "float32"}))
    jmodel, jcrit, jpost, _ = jax_build_model(args)
    rng = np.random.RandomState(0)
    imgs = [rng.randn(B, H, W, 3).astype(np.float32) for _ in range(2)]
    valid_hw = np.array([[60, 90]] * B, np.int32)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), JFrameBatch.from_images(
            jnp.asarray(imgs[0]), jnp.asarray(valid_hw))))
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(key, "key", "") in ("sampling_offsets",
                                            "attention_weights", "layer_2")
               for key in p) else x, params)
    cfg = FlagshipConfig().replace(compute_dtype="float32", **TINY)
    model, crit, post, _ = build_model(cfg, "cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(params))

    # ground truth planted on the port's own top-2 detections per image
    # (category = label + 1), and one box no detection comes near
    packs, jpacks, gts = [], [], {}
    for i, img in enumerate(imgs):
        batch = FrameBatch.from_images(torch.from_numpy(img),
                                       torch.from_numpy(valid_hw))
        model.eval()
        with torch.inference_mode():
            out = model(batch)[0]
        top = out["pred_logits"].sigmoid().amax(-1).argsort(1, True)[:, :2]
        picked = out["pred_boxes"].gather(
            1, top[..., None].expand(-1, -1, 4)).numpy()
        labels = out["pred_logits"].argmax(-1).gather(1, top).numpy()
        boxes = np.concatenate([picked, np.tile([[[0.1, 0.1, 0.05, 0.05]]],
                                                (B, T - 2, 1))], 1)
        tgt = targets_of(rng, B, T, [2 * i + 1, 2 * i + 2], boxes)
        tgt["labels"][:, :2] = labels
        for b, img_id in enumerate(tgt["image_id"]):
            cx, cy, w, h = (picked[b].T * [[180], [120], [180], [120]])
            gts[int(img_id)] = [
                ann(float(x - bw / 2), float(y - bh / 2), float(bw),
                    float(bh), int(lab) + 1)
                for x, y, bw, bh, lab in zip(cx, cy, w, h, labels[b])]
            gts[int(img_id)].append(ann(100.0, 80.0, 30.0, 20.0, 1))
        packs.append({"batch": batch, "targets": Targets(
            **{k: torch.from_numpy(v) for k, v in tgt.items()})})
        jpacks.append({"batch": JFrameBatch.from_images(
            jnp.asarray(img), jnp.asarray(valid_hw)), "targets": JTargets(
                **{k: jnp.asarray(v) for k, v in tgt.items()})})
    model.train()
    eval_args = types.SimpleNamespace(num_queries=TINY["num_queries"],
                                      vis_and_log_interval=1, masks=False,
                                      tracking=False)
    got = loop.evaluate(model, crit, {"bbox": post}, packs, lambda p: p,
                        FakeGT(gts), eval_args)
    assert model.training            # left in the mode it came in
    want = jloop.evaluate(jmodel, params, jcrit, {"bbox": jpost["bbox"]},
                          jpacks, lambda p: p, FakeGT(gts), eval_args)
    assert set(got) == set(want)
    assert 0.3 < want["AP"] < 1.0
    np.testing.assert_allclose(got["coco_eval_bbox"], want["coco_eval_bbox"],
                               atol=1e-6, rtol=0)
    for key in set(want) - {"coco_eval_bbox"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    # (the in-process tracking eval runs: tests/test_torch_train_cli.py;
    # `masks: true` is evaluated on a mask model: tests/test_torch_mots.py)
    # a panoptic postprocessor over ground truth with no panoptic files
    # (`ann_file`) adds nothing, as in the JAX `evaluate`
    again = loop.evaluate(model, crit, {"bbox": post, "panoptic": post},
                          packs, lambda p: p, FakeGT(gts), eval_args)
    assert set(again) == set(got)
    np.testing.assert_array_equal(again["coco_eval_bbox"],
                                  got["coco_eval_bbox"])
