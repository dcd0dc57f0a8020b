"""COCO panoptic in the port held against the JAX package on the CPU, on
the synthetic panoptic root of the JAX package's
`tests/test_panoptic_dataset.py` (three 96x128 images, two thing and two
stuff segments each, written here by `make_synth_panoptic`) and a tiny
`DETRSegm` (hidden 128, 8 heads, 1 + 1 layers, 8 queries, 251 softmax
logits):

  * the root itself, file for file, against the JAX test's writer;
  * `__getitem__` samples of both transforms (val and train, the same
    global numpy seeds) bit for bit, and the lazily decoded segment RLEs;
  * `postprocess_panoptic` on seeded outputs with confident queries,
    merged stuff segments and segments too small to keep: the PNG bytes
    and `segments_info` equal;
  * `PanopticEvaluator.summarize` on the same predictions: PQ, SQ and RQ
    equal;
  * `cli.train dataset=coco_panoptic masks=true eval_only=true` from one
    `.npz` in both CLIs: PQ_all / SQ_all / RQ_all equal (0 here: the random
    model's segments overlap no ground truth segment by half; PQ over
    matches is held above), the box and mask statistics within 1e-6 and
    the losses within 1e-4 (float32 summation order, as in
    `test_torch_eval.py`), and each written PNG's id map with the same
    segments and equal but for at most one pixel in 200: the two models'
    float32 mask logits differ by summation order, which moves a pixel
    where two queries' logits nearly tie to the other (as the masks of
    `test_torch_mots.py`).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from trackformer_tpu.datasets import panoptic_eval as jpanoptic_eval
from trackformer_tpu.datasets.builder import build_dataset as jbuild_dataset
from trackformer_tpu.models import panoptic as jpanoptic
from trackformer_tpu_torch.datasets import panoptic_eval
from trackformer_tpu_torch.datasets.builder import build_dataset
from trackformer_tpu_torch.models import panoptic
from trackformer_tpu_torch.models.factory import postprocessors
from trackformer_tpu_torch.utils.config import (FlagshipConfig, load_config,
                                                nested_namespace)

torch.set_num_threads(1)

H, W = 96, 128
IS_THING = {i: i <= 90 for i in range(250)}
TINY = [
    "enc_layers=1", "dec_layers=1", "hidden_dim=128", "nheads=8",
    "dim_feedforward=64", "num_queries=8", "batch_size=2",
    "num_workers=0", "epochs=1", "val_interval=0", "debug=true",
    "masks=true", "focal_loss=false", "deformable=false",
    "img_transform.max_size=160", "img_transform.val_width=128",
    "tpu.image_buckets=[[128,160]]", "tpu.max_objects=8",
    "tpu.compute_dtype=float32", "tpu.remat=false",
]


def make_synth_panoptic(root: Path, n_images: int = 3):
    """The JAX test's miniature COCO panoptic root under `root`: per image
    a sky and a ground stuff band (categories 200, 201) and two thing
    boxes (1, 2) with unique segment ids as an RGB id PNG, a JPEG of the
    segments' colours with noise, and the annotations JSON -> (coco root,
    panoptic root)."""
    img_dir = root / "coco" / "train2017"
    pan_dir = root / "panoptic" / "panoptic_train2017"
    ann_dir = root / "panoptic" / "annotations"
    for d in (img_dir, pan_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(n_images):
        name = f"{i:06d}"
        sky_id, gnd_id = 1000 + i * 10, 1001 + i * 10
        t1_id, t2_id = 5000 + i * 10, 5001 + i * 10
        seg = np.full((H, W), sky_id, np.int64)
        horizon = H // 2 + (i - 1) * 8
        seg[horizon:] = gnd_id
        y1, x1 = 20 + 5 * i, 16 + 10 * i
        seg[y1:y1 + 30, x1:x1 + 22] = t1_id
        y2, x2 = 50, 70 + 6 * i
        seg[y2:y2 + 28, x2:x2 + 18] = t2_id
        Image.fromarray(panoptic.id2rgb(seg)).save(pan_dir / f"{name}.png")
        img = np.zeros((H, W, 3), np.float32)
        for sid in (sky_id, gnd_id, t1_id, t2_id):
            img[seg == sid] = rng.uniform(40, 215, 3)
        img += rng.normal(0, 12, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            img_dir / f"{name}.jpg")
        segments = []
        for sid, cat in ((sky_id, 200), (gnd_id, 201), (t1_id, 1),
                         (t2_id, 2)):
            segments.append({"id": int(sid), "category_id": cat,
                             "iscrowd": 0, "area": int((seg == sid).sum())})
        images.append({"id": i, "file_name": f"{name}.jpg",
                       "height": H, "width": W})
        annotations.append({"image_id": i, "file_name": f"{name}.png",
                            "segments_info": segments})
    cats = [{"id": 1, "name": "person", "isthing": 1},
            {"id": 2, "name": "car", "isthing": 1},
            {"id": 200, "name": "sky", "isthing": 0},
            {"id": 201, "name": "ground", "isthing": 0}]
    (ann_dir / "panoptic_train2017.json").write_text(json.dumps(
        {"images": images, "annotations": annotations, "categories": cats}))
    return root / "coco", root / "panoptic"


@pytest.fixture(scope="module")
def pan_root(tmp_path_factory):
    return make_synth_panoptic(tmp_path_factory.mktemp("synthpan"))


def make_args(pan_root):
    coco_path, pan_path = pan_root
    over = {}
    for kv in TINY:
        k, v = kv.split("=", 1)
        try:
            over[k] = json.loads(v)
        except json.JSONDecodeError:
            over[k] = v
    over.update({"dataset": "coco_panoptic", "coco_path": str(coco_path),
                 "coco_panoptic_path": str(pan_path),
                 "train_split": "train", "val_split": "train"})
    return nested_namespace(load_config("train.yaml", [], over))


def test_synthetic_root_is_the_jax_tests(pan_root, tmp_path):
    from test_panoptic_dataset import make_synth_panoptic as jax_writer
    theirs = jax_writer(tmp_path)
    for ours, other in zip(pan_root, theirs):
        files = sorted(p.relative_to(ours) for p in ours.rglob("*")
                       if p.is_file())
        assert files == sorted(p.relative_to(other) for p in other.rglob("*")
                               if p.is_file())
        assert len(files) >= 3
        for f in files:
            assert (ours / f).read_bytes() == (other / f).read_bytes(), f


@pytest.mark.parametrize("image_set", ["val", "train"])
def test_samples_match_jax(pan_root, image_set):
    args = make_args(pan_root)
    ours, theirs = build_dataset(image_set, args), jbuild_dataset(image_set,
                                                                  args)
    assert len(ours) == len(theirs) == 3
    for idx in range(3):
        np.random.seed(10 + idx)
        got = ours[idx]
        np.random.seed(10 + idx)
        want = theirs[idx]
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["target"].keys() == want["target"].keys()
        for key, value in want["target"].items():
            np.testing.assert_array_equal(got["target"][key], value,
                                          err_msg=f"{idx} {key}")
        masks = got["target"]["masks"]
        assert masks.shape[0] == 4 and masks.any((1, 2)).all()
    # the detection facade: segment anns, RLEs decoded on fetch
    assert list(ours.anns_by_image) == list(theirs.anns_by_image)
    for img_id in ours.anns_by_image:
        assert ours.anns_by_image[img_id] == theirs.anns_by_image[img_id]
        assert all("segmentation" in a for a in ours.anns_by_image[img_id])


def crafted_outputs(seed: int, b: int = 2, q: int = 12, hm: int = 24,
                    wm: int = 32):
    """Seeded (B, Q, 251) logits and (B, Q, hm, wm) mask logits: half the
    queries confident of a class among the synthetic root's categories (a
    stuff class on two queries, which merge), one on a category drawn at
    random, the rest no-object or unsure; each confident query's mask a
    box, one of them a few pixels only."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, q, 251).astype(np.float32)
    masks = rng.randn(b, q, hm, wm).astype(np.float32) - 3.0
    for i in range(b):
        cats = [200, 201, 200, 1, 2, int(rng.randint(3, 250))]
        for k, cat in enumerate(cats):
            logits[i, k, cat] = 12.0
            y0, x0 = rng.randint(0, hm - 6), rng.randint(0, wm - 6)
            dy, dx = rng.randint(4, hm - y0), rng.randint(4, wm - x0)
            masks[i, k, y0:y0 + dy, x0:x0 + dx] += 8.0
        logits[i, len(cats), 250] = 12.0              # no-object
        masks[i, len(cats) - 1] -= 5.0
        masks[i, len(cats) - 1, 3, 4] = 9.0           # a tiny segment
    return {"pred_logits": logits, "pred_masks": masks}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_postprocess_matches_jax(seed):
    out = crafted_outputs(seed)
    sizes = [[90, 120], [96, 128]]
    targets = [[180, 240], [96, 128]]
    got = panoptic.postprocess_panoptic(out, sizes, IS_THING, targets)
    want = jpanoptic.postprocess_panoptic(out, sizes, IS_THING, targets)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["png_string"] == w["png_string"]
        assert g["segments_info"] == w["segments_info"]
        ids = panoptic.rgb2id(np.asarray(Image.open(
            __import__("io").BytesIO(g["png_string"])).convert("RGB")))
        areas = {s["id"]: s["area"] for s in g["segments_info"]}
        assert areas and all(a > panoptic.SMALL_SEGMENT
                             for a in areas.values())
        assert {int(i): int((ids == i).sum()) for i in np.unique(ids)} \
            == areas
    # torch tensors on the CPU go through as their arrays
    tensors = {k: torch.from_numpy(v) for k, v in out.items()}
    again = panoptic.postprocess_panoptic(tensors, sizes, IS_THING, targets)
    assert [p["png_string"] for p in again] == [p["png_string"]
                                                for p in got]


def gt_like_predictions(pan_root):
    """Predictions of the root's images made from its ground truth: each
    segment a confident query of its category with the segment's mask as
    logits at a quarter of the size, the ground stuff split across two
    queries, the second thing of the last image misclassified, one extra
    false positive."""
    _, pan_path = pan_root
    gt = json.loads((pan_path / "annotations" /
                     "panoptic_train2017.json").read_text())
    outs = []
    for ann in gt["annotations"]:
        with Image.open(pan_path / "panoptic_train2017"
                        / ann["file_name"]) as im:
            ids = panoptic.rgb2id(np.asarray(im.convert("RGB")))[::4, ::4]
        segs = ann["segments_info"]
        q = len(segs) + 2
        logits = np.full((1, q, 251), -5.0, np.float32)
        masks = np.full((1, q, H // 4, W // 4), -6.0, np.float32)
        for k, s in enumerate(segs):
            cat = s["category_id"]
            if ann["image_id"] == 2 and cat == 2:
                cat = 3
            logits[0, k, cat] = 10.0
            masks[0, k][ids == s["id"]] = 6.0
        logits[0, -2, 201] = 10.0                 # the ground's other half
        ground = ids == segs[1]["id"]
        masks[0, -2][ground] = 5.0
        masks[0, -2][:, W // 8:][ground[:, W // 8:]] = 7.0
        logits[0, -1, 1] = 10.0                   # a false positive
        masks[0, -1, 2:6, 20:28] = 8.0
        outs.append((ann["image_id"], {"pred_logits": logits,
                                       "pred_masks": masks}))
    return outs


def test_summarize_matches_jax(pan_root, tmp_path):
    _, pan_path = pan_root
    ann_file = pan_path / "annotations" / "panoptic_train2017.json"
    ann_folder = pan_path / "panoptic_train2017"
    ours = panoptic_eval.PanopticEvaluator(str(ann_file), str(ann_folder),
                                           str(tmp_path / "port"))
    theirs = jpanoptic_eval.PanopticEvaluator(str(ann_file), str(ann_folder),
                                              str(tmp_path / "jax"))
    for img_id, out in gt_like_predictions(pan_root):
        for ev, post in ((ours, panoptic), (theirs, jpanoptic)):
            preds = post.postprocess_panoptic(out, [[H, W]], IS_THING)
            preds[0]["image_id"] = img_id
            ev.update(preds)
    got, want = ours.summarize(), theirs.summarize()
    assert got == want
    assert 0.3 < got["PQ"] < 1.0 and got["RQ"] < 1.0 and got["SQ"] > 0.5
    for f in sorted((tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes()


def test_factory_postprocessors(pan_root):
    cfg = FlagshipConfig.from_config(load_config(
        "train.yaml", [], {"dataset": "coco_panoptic", "masks": True}))
    post = postprocessors(cfg)
    assert set(post) == {"bbox", "segm", "panoptic"}
    assert post["panoptic"].keywords["threshold"] == 0.85
    assert post["panoptic"].keywords["is_thing_map"] == IS_THING
    assert "panoptic" not in postprocessors(cfg.replace(masks=False))


@pytest.fixture(scope="module")
def both_cli_evals(pan_root, tmp_path_factory):
    """`eval_only` through both training CLIs from one `.npz` of the tiny
    `DETRSegm` (weights drawn from a numpy seed, the class head's columns
    of the root's four categories and of no-object large, so that most
    queries pass the 0.85 softmax threshold as one of them)."""
    import jax
    import jax.numpy as jnp

    from trackformer_tpu.cli.train import main as jax_main
    from trackformer_tpu.models import build_model as jax_build_model
    from trackformer_tpu.structures import FrameBatch as JFrameBatch
    from trackformer_tpu.utils.checkpoint import save_params_npz
    from trackformer_tpu_torch.cli.train import main

    args = make_args(pan_root)
    jmodel = jax_build_model(args)[0]
    jb = JFrameBatch.from_images(jnp.zeros((1, 128, 160, 3)),
                                 jnp.asarray([[96, 128]]))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        if name in ("scale", "weight"):
            return (1.0 + 0.05 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "running_var":
            return (1.0 + 0.1 * rng.rand(*leaf.shape)).astype(np.float32)
        if name in ("bias", "running_mean"):
            return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.randn(*leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    head = params["params"]["class_embed"]
    kernel = head["kernel"] * 0.1
    for col in (1, 2, 200, 201, 250):
        kernel[:, col] = 3.0 * rng.randn(kernel.shape[0])
    head["kernel"] = kernel.astype(np.float32)
    root = tmp_path_factory.mktemp("pancli")
    save_params_npz(params, root / "weights.npz")
    coco_path, pan_path = pan_root
    argv = ["with", *TINY, "dataset=coco_panoptic", "eval_only=true",
            f"coco_path={coco_path}", f"coco_panoptic_path={pan_path}",
            "train_split=train", "val_split=train", "tracking=false",
            "tracking_eval=false", f"resume={root / 'weights.npz'}"]
    got = main(argv + [f"output_dir={root / 'port'}"], device="cpu")
    want = jax_main(argv + [f"output_dir={root / 'jax'}"])
    return got, want, root


def test_train_cli_panoptic_eval_matches_jax(both_cli_evals):
    got, want, root = both_cli_evals
    assert set(got) == set(want)
    assert {"PQ_all", "SQ_all", "RQ_all", "coco_eval_masks"} <= set(got)
    for key in ("PQ_all", "SQ_all", "RQ_all"):
        assert got[key] == want[key], key
    for key in ("coco_eval_bbox", "coco_eval_masks"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0)
    for key in set(want) - {"coco_eval_bbox", "coco_eval_masks", "PQ_all",
                            "SQ_all", "RQ_all"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    pngs = sorted((root / "jax" / "panoptic_eval").iterdir())
    assert len(pngs) == 2           # one batch of 2 (the loader drops the last)
    n_segments = 0
    for f in pngs:
        with Image.open(f) as im:
            want_ids = panoptic.rgb2id(np.asarray(im.convert("RGB")))
        with Image.open(root / "port" / "panoptic_eval" / f.name) as im:
            got_ids = panoptic.rgb2id(np.asarray(im.convert("RGB")))
        assert got_ids.shape == want_ids.shape == (H, W)
        assert set(np.unique(got_ids)) == set(np.unique(want_ids))
        assert (got_ids != want_ids).sum() <= got_ids.size // 200, f.name
        n_segments += len(np.unique(want_ids))
    assert n_segments > 4           # the queries passed the threshold
