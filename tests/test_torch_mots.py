"""The MOTS20 recipe's data, tracking and evaluation in the port held
against the JAX package on the CPU, on a synthetic MOTS20 layout (moving
rectangles with their masks, the ground truth written as MOTS lines by the
port's `mots_line`) and a tiny `DETRSegm` (`train.yaml` + `mots20`: 1 + 2
layers, hidden 128, 8 heads, 10 queries, softmax classes):

  * `MOTS20Sequence`: the blobs and the boxes of the mask ground truth,
    and a result file written and read back, byte for byte;
  * `upscale_mask_results` on seeded head-resolution masks, bit for bit;
  * `evaluate` of the mask model with `masks: true` (box and mask AP)
    against the JAX `evaluate`;
  * `cli.track` over the layout with both trackers (`tpu.batch_sequences`
    1 and 2) against the JAX CLI: the same MOTS rows (frame, id, class,
    size) and the same MOT summary; each row's mask equal but for at most
    one pixel in 200 (the mask head's float32 output differs from JAX's
    by summation order, which moves a probability near 0.5 or near a tie
    of two tracks across it).

The tracker's thresholds are raised into the random model's score range.
"""
import configparser
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_variants import jax_params
from trackformer_tpu import native as jnative
from trackformer_tpu.cli.track import main as jax_main
from trackformer_tpu.datasets.tracking import \
    TrackDatasetFactory as JFactory
from trackformer_tpu.engine import loop as jloop
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import Targets as JTargets
from trackformer_tpu.utils import track_utils as jtrack_utils
from trackformer_tpu.utils.checkpoint import save_params_npz
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch import native
from trackformer_tpu_torch.cli.track import main
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.datasets.tracking import TrackDatasetFactory
from trackformer_tpu_torch.datasets.tracking.mots20_sequence import (
    load_mots_gt, mots_line)
from trackformer_tpu_torch.engine import loop
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.models.factory import postprocessors
from trackformer_tpu_torch.structures import FrameBatch, Targets
from trackformer_tpu_torch.utils import rle, track_utils
from trackformer_tpu_torch.utils.config import FlagshipConfig

sys.path.insert(0, str(Path(__file__).parent))
from synth_data import make_synth_mot  # noqa: E402

torch.set_num_threads(1)

SEQS = ["MOTS20-02", "MOTS20-05"]
TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 128, "nheads": 8,
        "dim_feedforward": 64, "num_queries": 10,
        "img_transform.max_size": 170, "img_transform.val_width": 128,
        "tpu.compute_dtype": "float32"}
TRACKER = ["tracker_cfg.detection_obj_score_thresh=0.5",
           "tracker_cfg.track_obj_score_thresh=0.55", "tpu.max_tracks=8"]


def make_mots_layout(root: Path, names=SEQS, n_frames: int = 4,
                     hw=(128, 160)) -> Path:
    """`<root>/MOTS20/train/<name>/` sequences of moving rectangles
    (`tests/synth_data.py`) with their ground truth as MOTS lines: each
    rectangle's mask (its top-left pixel cut off every other object) as a
    pedestrian 2000 + id, one car and one ignore region -> `root`."""
    data = root / "MOTS20"
    make_synth_mot(data, n_seqs=len(names), n_frames=n_frames, hw=hw)
    h, w = hw
    for k, name in enumerate(names):
        seq = data / "train" / name
        (data / "train" / f"SYN-{k + 1:02d}").rename(seq)
        ini = configparser.ConfigParser()
        ini.read(seq / "seqinfo.ini")
        ini["Sequence"]["name"] = name
        with open(seq / "seqinfo.ini", "w") as f:
            ini.write(f)
        gt = seq / "gt" / "gt.txt"
        out = []
        for line in gt.read_text().splitlines():
            r = line.split(",")
            x, y, bw, bh = (int(float(v)) for v in r[2:6])
            m = np.zeros((h, w), bool)
            m[y - 1:y - 1 + bh, x - 1:x - 1 + bw] = True
            m[y - 1, x - 1] = int(r[1]) % 2 == 0
            out.append(mots_line(int(r[0]), 2000 + int(r[1]), 2, m))
        car = np.zeros((h, w), bool)
        car[100:120, 5:40] = True
        out += [mots_line(1, 1003, 1, car), mots_line(2, 10000, 10, car)]
        gt.write_text("".join(out))
    return root


@pytest.fixture(scope="module")
def mots_root(tmp_path_factory):
    return make_mots_layout(tmp_path_factory.mktemp("mots"))


def test_mots20_sequence_matches_jax(mots_root, tmp_path):
    """Blobs with the pedestrians' boxes from their masks (the car and the
    ignore region left out); results with masks written as the JAX
    sequence writes them and read back as it reads them."""
    jseq = JFactory(SEQS[0], root_dir=str(mots_root), img_transform=None)[0]
    tseq = TrackDatasetFactory(SEQS[0], root_dir=str(mots_root),
                               img_transform=None)[0]
    assert str(tseq) == str(jseq) and len(tseq) == len(jseq) == 4
    assert not tseq.no_gt
    for i in range(len(jseq)):
        for key in ("gt", "vis"):
            assert tseq.data[i][key].keys() == jseq.data[i][key].keys()
            for tid in jseq.data[i][key]:
                np.testing.assert_array_equal(tseq.data[i][key][tid],
                                              jseq.data[i][key][tid])
        assert len(tseq.data[i]["gt"]) == 2
    rng = np.random.RandomState(0)
    results = {tid: {f: {"bbox": np.zeros(4, np.float32), "score": 1.0,
                         "mask": rng.rand(128, 160) > 0.7}
                     for f in range(tid, 4)} for tid in range(3)}
    results[1][3] = {"bbox": np.zeros(4, np.float32)}  # no mask: skipped
    jseq.write_results(results, str(tmp_path / "jax"))
    tseq.write_results(results, str(tmp_path / "port"))
    name = f"{SEQS[0]}.txt"
    port_file = (tmp_path / "port" / name).read_text()
    assert port_file == (tmp_path / "jax" / name).read_text()
    assert port_file.splitlines()[0].split(" ")[:3] == ["1", "2001", "2"]
    got = tseq.load_results(str(tmp_path / "port"))
    want = jseq.load_results(str(tmp_path / "port"))
    assert got.keys() == want.keys()
    for tid in want:
        assert got[tid].keys() == want[tid].keys()
        for f in want[tid]:
            for key in ("bbox", "mask"):
                np.testing.assert_array_equal(got[tid][f][key],
                                              want[tid][f][key])
    assert set(load_mots_gt(str(tmp_path / "port" / name))) == {1, 2, 3, 4}


def test_upscale_mask_results_matches_jax():
    rng = np.random.RandomState(1)
    tracks = {tid: {f: {"bbox": np.zeros(4, np.float32), "score": 0.9,
                        "mask": rng.rand(32, 48) > 0.5}
                    for f in range(3)} for tid in range(2)}
    tracks[1][2] = {"bbox": np.ones(4, np.float32)}
    for size, orig, pad in (((128, 160), (128, 160), (128, 192)),
                            ((125, 186), (540, 960), (128, 192))):
        got = track_utils.upscale_mask_results(tracks, size, orig, pad)
        want = jtrack_utils.upscale_mask_results(tracks, size, orig, pad)
        assert got.keys() == want.keys()
        for tid in want:
            for f in want[tid]:
                assert got[tid][f].keys() == want[tid][f].keys()
                if "mask" in want[tid][f]:
                    assert got[tid][f]["mask"].shape == tuple(orig)
                    np.testing.assert_array_equal(got[tid][f]["mask"],
                                                  want[tid][f]["mask"])


def recipe_config():
    return load_config("train.yaml", ["mots20"], TINY)


def recipe_params(seed=0):
    """Tiny `DETRSegm` weights: a person detector whose person scores
    spread over 0.3-0.7 across the queries."""
    jmodel = jax_build_model(nested_namespace(recipe_config()))[0]
    params = jax_params(jmodel, seed=seed)
    head = params["params"]["class_embed"]
    head["bias"] = head["bias"].copy()
    head["bias"][0] = 4.5
    head["kernel"] = head["kernel"].copy()
    head["kernel"][:, 0] *= 15
    return jmodel, params


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("model")
    with open(model_dir / "config.yaml", "w") as f:
        yaml.safe_dump(recipe_config(), f)
    save_params_npz(recipe_params()[1], model_dir / "checkpoint.npz")
    return model_dir / "checkpoint.npz"


def read_mots_rows(path: Path) -> dict:
    """{(frame, id): (class, h, w, decoded mask)}."""
    out = {}
    for frame, objs in load_mots_gt(str(path)).items():
        for obj in objs:
            out[(frame, obj["track_id"])] = (
                obj["class_id"], tuple(obj["mask"]["size"]),
                rle.decode_mask(obj["mask"]))
    return out


@pytest.mark.parametrize("batch_sequences", [1, 2])
def test_track_cli_mots_matches_jax(mots_root, checkpoint, tmp_path,
                                    monkeypatch, batch_sequences):
    monkeypatch.setattr(jnative, "_LIB", native.load())
    monkeypatch.setattr(jnative, "_TRIED", True)
    argv = ["with", "dataset_name=[" + ",".join(SEQS) + "]",
            f"data_root_dir={mots_root}",
            f"obj_detect_checkpoint_file={checkpoint}",
            f"tpu.batch_sequences={batch_sequences}", *TRACKER]
    want = jax_main(argv + [f"output_dir={tmp_path / 'jax'}"])
    got = main(argv + [f"output_dir={tmp_path / 'port'}"], device="cpu")
    n_rows = 0
    for name in SEQS:
        jrows = read_mots_rows(tmp_path / "jax" / f"{name}.txt")
        trows = read_mots_rows(tmp_path / "port" / f"{name}.txt")
        assert trows.keys() == jrows.keys(), name
        for key, (cls, size, mask) in trows.items():
            jcls, jsize, jmask = jrows[key]
            assert (cls, size) == (jcls, jsize) == (2, (128, 160))
            assert (mask != jmask).sum() <= mask.size // 200, key
        n_rows += len(trows)
        frames = {f for f, _ in trows}
        assert len(frames) >= 3, name
    assert n_rows > 0
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name


def test_evaluate_masks_matches_jax():
    """`evaluate` with `masks: true` over one pack of two frames whose
    ground truth (with masks) is the port's own top detections: the
    losses (with `loss_mask` / `loss_dice`), the 12 box and the 12 mask
    statistics against JAX."""
    from trackformer_tpu.models import build_model as jbm
    cfg_dict = recipe_config()
    args = nested_namespace(cfg_dict)
    jmodel, jcrit, jpost, _ = jbm(args)
    _, params = recipe_params()
    cfg = FlagshipConfig.from_config(cfg_dict)
    model, crit, _, _ = build_model(cfg, "cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(params))
    rng = np.random.RandomState(2)
    img = rng.randn(2, 64, 96, 3).astype(np.float32)
    valid_hw = np.array([[60, 90]] * 2, np.int32)
    batch = FrameBatch.from_images(torch.from_numpy(img),
                                   torch.from_numpy(valid_hw))
    model.eval()
    with torch.inference_mode():
        out = model(batch)[0]
    scores = out["pred_logits"].softmax(-1)[..., 0]
    top = scores.argsort(1, True)[:, :2]
    boxes = out["pred_boxes"].gather(1, top[..., None].expand(-1, -1, 4))
    boxes = boxes.numpy().astype(np.float32)
    masks = (out["pred_masks"].gather(1, top[..., None, None].expand(
        -1, -1, 16, 24)) > 0).repeat_interleave(4, 2).repeat_interleave(
            4, 3).numpy()
    tgt = dict(labels=np.zeros((2, 2), np.int32), boxes=boxes,
               valid=np.ones((2, 2), bool),
               track_ids=np.array([[0, 1], [2, 3]], np.int32),
               orig_size=np.tile([[120, 180]], (2, 1)).astype(np.int32),
               size=valid_hw, image_id=np.array([1, 2], np.int32),
               masks=masks)
    gts = {}
    for i in range(2):
        anns = []
        for j in range(2):
            cx, cy, w, h = boxes[i, j] * [180, 120, 180, 120]
            from PIL import Image
            m = np.asarray(Image.fromarray(
                masks[i, j, :60, :90].astype(np.uint8)).resize(
                    (180, 120), Image.NEAREST)).astype(bool)
            anns.append({"bbox": [cx - w / 2, cy - h / 2, w, h],
                         "category_id": 1, "iscrowd": 0, "ignore": 0,
                         "area": float(w * h),
                         "segmentation": rle.encode_mask(m)})
        gts[i + 1] = anns

    class GT:
        anns_by_image = gts
        images = {}

    tpack = {"batch": batch,
             "targets": Targets(**{k: torch.from_numpy(v)
                                   for k, v in tgt.items()})}
    jpack = {"batch": JFrameBatch.from_images(jnp.asarray(img),
                                              jnp.asarray(valid_hw)),
             "targets": JTargets(**{k: jnp.asarray(v)
                                    for k, v in tgt.items()})}
    eval_args = type("A", (), {"num_queries": 10, "masks": True,
                               "vis_and_log_interval": 50})()
    got = loop.evaluate(model, crit, postprocessors(cfg), [tpack],
                        lambda p: p, GT(), eval_args)
    want = jloop.evaluate(jmodel, jax.tree.map(jnp.asarray, params), jcrit,
                          jpost, [jpack], lambda p: p, GT(), eval_args)
    for key in ("coco_eval_bbox", "coco_eval_masks"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0,
                                   err_msg=key)
    assert 0 < want["AP_masks"] < want["AP"]
    for key in ("loss_mask", "loss_dice", "loss_ce", "loss_bbox"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
