"""Vanilla DETR's attention maps and the tracker's soft reset in the port,
held against the JAX package on the CPU with a tiny vanilla DETR
(`train.yaml` + `mots20` without masks: 1 + 2 layers, hidden 128, 8 heads,
10 queries, softmax classes) from one set of weights:

  * `AttentionMapDETR`: the last decoder layer's head-averaged
    cross-attention weights against the weights the JAX attention sows,
    read as the JAX track CLI reads them (`mutable=["intermediates"]`);
  * the `Tracker` with attention maps (the JAX `Tracker` with
    `attn_hw="auto"`) over a sequence, `reset(hard=False)` partway, then
    more frames: per frame the active ids; `frame_index`, `num_reids` and
    `get_results()` (the same tracks and frames, boxes to 1e-3 pixels,
    each track's "attention_map" to 2e-6 + 1e-4 |ref|: float32 softmax
    weights of summation order apart);
  * `cli.track generate_attention_maps=true` against the JAX CLI: the same
    rows, boxes to 1e-3 pixels, the same MOT summary; a Deformable model
    refused in both;
  * `plot_sequence` with the maps: the JAX function's image pixels.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from test_torch_track_cli import _rename, read_rows
from test_torch_variants import jax_params
from trackformer_tpu import native as jnative
from trackformer_tpu.cli.track import main as jax_main
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models.postprocess import postprocess_softmax as jpost
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.tracking import tracker as jtr
from trackformer_tpu.utils import track_utils as jtrack_utils
from trackformer_tpu.utils.checkpoint import save_params_npz
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch import native
from trackformer_tpu_torch.cli.track import main
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.models.detr import AttentionMapDETR
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import Tracker
from trackformer_tpu_torch.tracking.tracker import attn_hw_of
from trackformer_tpu_torch.utils import track_utils
from trackformer_tpu_torch.utils.config import FlagshipConfig

sys.path.insert(0, str(Path(__file__).parent))
from synth_data import make_synth_mot  # noqa: E402

torch.set_num_threads(1)

TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 128, "nheads": 8,
        "dim_feedforward": 64, "num_queries": 10, "masks": False,
        "img_transform.max_size": 170, "img_transform.val_width": 128,
        "tpu.compute_dtype": "float32"}
H, W = 128, 160
VALID_HW = np.array([[120, 150]], np.int32)
ORIG = np.array([[240, 300]], np.int32)
TRACKER = {**FlagshipConfig().tracker_cfg, "max_tracks": 8,
           "detection_obj_score_thresh": 0.5, "track_obj_score_thresh": 0.55}
# frames before and after the soft reset
BEFORE, AFTER = 3, 3
ATTN_TOL = (2e-6, 1e-4)
SEQS = ["MOT17-02-FRCNN", "MOT17-04-FRCNN"]


def config():
    return load_config("train.yaml", ["mots20"], TINY)


def model_params(seed=0):
    """Tiny vanilla DETR weights: a person detector whose person scores
    spread over 0.3-0.7 across the queries."""
    jmodel = jax_build_model(nested_namespace(config()))[0]
    params = jax_params(jmodel, seed=seed)
    head = params["params"]["class_embed"]
    head["bias"] = head["bias"].copy()
    head["bias"][0] = 9.3
    return jmodel, params


def jax_apply_with_maps(jmodel, dec_layers):
    """The JAX track CLI's `apply_fn` with `generate_attention_maps`."""
    def apply_fn(p, b, t, pf):
        (out, tgts, feats, memory, hs), inters = jmodel.apply(
            p, b, t, pf, deterministic=True, mutable=["intermediates"])
        attn = inters["intermediates"]["transformer"][
            f"decoder_layer_{dec_layers - 1}"]["multihead_attn"][
            "attn_weights"][0]
        mh, mw = memory.shape[1:3]
        out["attention_maps"] = attn.reshape(attn.shape[0], attn.shape[1],
                                             mh, mw)
        return out, tgts, feats, memory, hs
    return apply_fn


def frames():
    rng = np.random.RandomState(0)
    base = rng.randn(1, H, W, 3).astype(np.float32)
    out = []
    for t in range(BEFORE + AFTER):
        img = np.roll(base, (2 * t, 3 * t), axis=(1, 2))
        out.append(img + 0.3 * rng.randn(*img.shape).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def jax_run():
    jmodel, params = model_params()
    tracker = jtr.Tracker(params, jax_apply_with_maps(jmodel, 2), jpost,
                          TRACKER, hidden_dim=128, num_object_queries=10,
                          attn_hw="auto")
    ids = []
    for t, img in enumerate(frames()):
        if t == BEFORE:
            tracker.reset(hard=False)
        tracker.step({"batch": JFrameBatch.from_images(
            jnp.asarray(img), jnp.asarray(VALID_HW)),
            "orig_size": jnp.asarray(ORIG)})
        ids.append(sorted(np.asarray(tracker.state.ids)[np.asarray(
            tracker.state.active)].tolist()))
    return params, dict(ids=ids, results=tracker.get_results(),
                        frame_index=tracker.frame_index,
                        num_reids=tracker.num_reids,
                        attn_hw=tracker.attn_hw)


def port_model(params):
    model, post = build_model(FlagshipConfig.from_config(config()), "cpu")
    model.load_state_dict(jax_params_to_state_dict(params))
    return model, post


def blob(img):
    return {"batch": FrameBatch.from_images(torch.from_numpy(img),
                                            torch.from_numpy(VALID_HW)),
            "orig_size": torch.from_numpy(ORIG)}


def test_attention_maps_match_the_sown_weights():
    jmodel, params = model_params()
    model, _ = port_model(params)
    wrapped = AttentionMapDETR(model)
    img = frames()[0]
    want = jax_apply_with_maps(jmodel, 2)(
        params, JFrameBatch.from_images(jnp.asarray(img),
                                        jnp.asarray(VALID_HW)), None, None)
    with torch.inference_mode():
        got = wrapped(blob(img)["batch"])
        plain = model(blob(img)["batch"])[0]
    maps = got[0]["attention_maps"]
    assert maps.shape == (1, 10) + attn_hw_of((H, W), wrapped.stride)
    assert wrapped.stride == 32 and attn_hw_of((H, W), 32) == (4, 5)
    np.testing.assert_allclose(maps.numpy(),
                               np.asarray(want[0]["attention_maps"]),
                               atol=ATTN_TOL[0], rtol=ATTN_TOL[1])
    # padded keys take no weight; each query's weights sum to 1
    np.testing.assert_allclose(maps.sum((2, 3)).numpy(), 1.0, atol=1e-5)
    # the flag is off again, and the plain model's outputs are the same
    attn = model.transformer.decoder.layers[-1].multihead_attn
    assert not attn.keep_weights and attn.weights is None
    assert "attention_maps" not in plain
    assert torch.equal(plain["pred_boxes"], got[0]["pred_boxes"])
    with pytest.raises(ValueError, match="vanilla DETR"):
        AttentionMapDETR(build_model(FlagshipConfig(
            compute_dtype="float32", enc_layers=1, dec_layers=1,
            hidden_dim=96, nheads=4, num_queries=4), "cpu")[0])


def test_tracker_with_maps_and_soft_reset_matches_jax(jax_run):
    params, want = jax_run
    model, post = port_model(params)
    wrapped = AttentionMapDETR(model)
    tracker = Tracker(wrapped, post, TRACKER, 128, 10,
                      attn_stride=wrapped.stride)
    ids = []
    for t, img in enumerate(frames()):
        if t == BEFORE:
            tracker.reset(hard=False)
        tracker.step(blob(img))
        ids.append(sorted(tracker.state.ids[tracker.state.active].tolist()))
    assert ids == want["ids"]
    assert tracker.frame_index == want["frame_index"] == BEFORE + AFTER
    assert tracker.num_reids == want["num_reids"]
    assert tuple(tracker.state.attn_maps.shape[1:]) == want["attn_hw"]
    got, jres = tracker.get_results(), want["results"]
    assert got.keys() == jres.keys()
    n_maps = 0
    for tid in jres:
        assert got[tid].keys() == jres[tid].keys(), tid
        for f, entry in jres[tid].items():
            np.testing.assert_allclose(got[tid][f]["bbox"], entry["bbox"],
                                       atol=1e-3)
            np.testing.assert_allclose(
                got[tid][f]["attention_map"],
                np.asarray(entry["attention_map"]), atol=ATTN_TOL[0],
                rtol=ATTN_TOL[1], err_msg=f"{tid} {f}")
            n_maps += 1
    # tracks on both sides of the reset
    frames_seen = {f for t in got.values() for f in t}
    assert min(frames_seen) < BEFORE <= max(frames_seen)
    assert n_maps > 0
    # a hard reset clears the results
    tracker.reset()
    assert tracker.get_results() == {} and tracker.frame_index == 0


@pytest.fixture(scope="module")
def mot17_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("attnmot17") / "MOT17"
    make_synth_mot(root, n_seqs=2, n_frames=4)
    for k, name in enumerate(SEQS):
        _rename(root, f"SYN-{k + 1:02d}", name)
    return root.parent


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("attnmodel")
    with open(model_dir / "config.yaml", "w") as f:
        yaml.safe_dump(config(), f)
    save_params_npz(model_params()[1], model_dir / "checkpoint.npz")
    return model_dir / "checkpoint.npz"


def test_track_cli_with_attention_maps_matches_jax(mot17_root, checkpoint,
                                                   tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB", native.load())
    monkeypatch.setattr(jnative, "_TRIED", True)
    argv = ["with", "dataset_name=[" + ",".join(SEQS) + "]",
            f"data_root_dir={mot17_root}",
            f"obj_detect_checkpoint_file={checkpoint}",
            "generate_attention_maps=true",
            "tracker_cfg.detection_obj_score_thresh=0.5",
            "tracker_cfg.track_obj_score_thresh=0.55", "tpu.max_tracks=8"]
    want = jax_main(argv + [f"output_dir={tmp_path / 'jax'}"])
    got = main(argv + [f"output_dir={tmp_path / 'port'}"], device="cpu")
    n_rows = 0
    for name in SEQS:
        jrows = read_rows(tmp_path / "jax" / f"{name}.txt")
        trows = read_rows(tmp_path / "port" / f"{name}.txt")
        assert trows.keys() == jrows.keys(), name
        for key, box in trows.items():
            np.testing.assert_allclose(box, jrows[key], atol=1e-3, rtol=0)
        n_rows += len(trows)
    assert n_rows > 0
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    # a Deformable model is refused
    deformable = ["with", f"dataset_name={SEQS[0]}",
                  f"data_root_dir={mot17_root}",
                  "obj_detect_checkpoint_file=null",
                  "generate_attention_maps=true"]
    with pytest.raises(ValueError, match="vanilla DETR"):
        main(deformable, device="cpu")


def test_plot_sequence_with_maps_matches_jax(mot17_root, tmp_path):
    """Seeded boxes and attention maps (3 x 4, as the tiny model's memory
    over a 96x128 frame would be) on the sequence's 128x160 frames; one
    track without a map in one frame."""
    from trackformer_tpu.datasets.tracking import \
        TrackDatasetFactory as JFactory
    from trackformer_tpu_torch.datasets.tracking import TrackDatasetFactory
    rng = np.random.RandomState(3)
    tracks = {}
    for tid in range(3):
        tracks[tid] = {}
        for f in range(4):
            x0, y0 = rng.uniform(0, 100), rng.uniform(0, 80)
            tracks[tid][f] = {
                "bbox": np.array([x0, y0, x0 + 40, y0 + 30], np.float32),
                "score": 0.9,
                "attention_map": rng.rand(3, 4).astype(np.float32)}
    del tracks[1][2]["attention_map"]
    jseq = JFactory(SEQS[0], root_dir=str(mot17_root), img_transform=None)[0]
    tseq = TrackDatasetFactory(SEQS[0], root_dir=str(mot17_root),
                               img_transform=None)[0]
    jtrack_utils.plot_sequence(tracks, jseq, str(tmp_path / "jax"),
                               "debug", generate_attention_maps=True)
    track_utils.plot_sequence(tracks, tseq, str(tmp_path / "port"),
                              "debug", generate_attention_maps=True)
    track_utils.plot_sequence(tracks, tseq, str(tmp_path / "plain"),
                              "debug")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 4
    for name in names:
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        got = np.asarray(Image.open(tmp_path / "port" / name))
        assert np.array_equal(got, want), name
        plain = np.asarray(Image.open(tmp_path / "plain" / name))
        assert not np.array_equal(got, plain), name
