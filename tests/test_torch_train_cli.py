"""The port's training CLI (trackformer_tpu_torch.cli.train) on the CPU, at
a tiny width of the flagship's named configs (`deformable tracking
multi_frame`) in float32 over a synthetic MOT dataset:

  * a debug epoch writes `config.yaml`, the train state and the weights;
    a `resume_optim` run continues the step count, validates and logs to
    `vis/`;
  * `eval_only` from one shared `.npz` (the port's own checkpoint, with the
    class bias raised so that every query detects) in the port's CLI and
    in the JAX package's `trackformer_tpu.cli.train.main`: the 12 COCO box
    statistics within 1e-6 absolute and the losses within 1e-4 (the two
    models differ by float32 summation order, as in `test_torch_eval.py`),
    and, through the in-process tracking eval (each CLI re-entering its
    own `cli.track` with its live model, both on the native frame
    preprocessing and with 8 track slots), MOTA and IDF1 equal;
  * the options that are not ported raise, naming their ROADMAP item.
"""
import configparser
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trackformer_tpu_torch.cli.train import main
from trackformer_tpu_torch.utils.checkpoint import (load_params_npz,
                                                    save_params_npz)

sys.path.insert(0, str(Path(__file__).parent))
from synth_data import make_synth_mot  # noqa: E402

torch.set_num_threads(1)

TINY = [
    "deformable", "tracking", "multi_frame",
    "enc_layers=1", "dec_layers=2", "hidden_dim=96", "nheads=4",
    "dim_feedforward=128", "num_queries=12", "batch_size=2",
    "track_prev_frame_range=2", "vis_and_log_interval=1",
    "img_transform.max_size=160", "img_transform.val_width=128",
    "tpu.image_buckets=[[128,160]]", "tpu.max_objects=8",
    "tpu.compute_dtype=float32", "tpu.remat=false",
]
TRACK_SEQ = "MOT17-02-FRCNN"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(argv of the dataset, the tracking eval's data root): the synthetic
    MOT split, and its first sequence under a name that the tracking
    registry knows."""
    root = tmp_path_factory.mktemp("trainclimot")
    make_synth_mot(root, n_seqs=2, n_frames=4)
    track_root = root / "track"
    dst = track_root / "MOT17" / "train" / TRACK_SEQ
    shutil.copytree(root / "train" / "SYN-01", dst)
    ini = configparser.ConfigParser()
    ini.read(dst / "seqinfo.ini")
    ini["Sequence"]["name"] = TRACK_SEQ
    with open(dst / "seqinfo.ini", "w") as f:
        ini.write(f)
    argv = ["dataset=mot", f"mot_path_train={root}", f"mot_path_val={root}",
            "train_split=synth_train", "val_split=synth_train",
            f"val_track_dataset={TRACK_SEQ}", f"data_root_dir={track_root}"]
    return argv, track_root


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """A debug epoch, then a resumed run of a full epoch: (output dir, the
    two states' step counts)."""
    out = tmp_path_factory.mktemp("trainout")
    common = ["with", *TINY, *data[0], "tracking_eval=false",
              f"output_dir={out}"]
    first = main(common + ["epochs=1", "debug=true"], device="cpu").step
    second = main(common + ["epochs=2", "resume_optim=true", "val_interval=1"],
                  device="cpu").step
    return out, first, second


def test_debug_epoch_then_resume(trained):
    out, first, second = trained
    assert first == 2                       # debug: two steps
    assert second == first + 4              # 8 samples, B = 2
    assert (out / "config.yaml").exists()
    assert (out / "checkpoint.pt").exists()
    assert (out / "checkpoint_params.npz").exists()
    assert json.loads((out / "meta.json").read_text())["epoch"] == 2
    assert (out / "checkpoint_best_AP.npz").exists()
    epochs = [json.loads(line) for line in
              (out / "vis" / "epoch_metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in epochs] == [2]
    assert {"loss", "grad_norm", "AP", "AP50"} <= set(epochs[0])
    iters = (out / "vis" / "iter_metrics.jsonl").read_text().splitlines()
    assert len(iters) == 4 + 4          # 4 train steps, 4 val batches


@pytest.fixture(scope="module")
def both_evals(data, trained, tmp_path_factory):
    """`eval_only` with the tracking eval through both CLIs from one
    `.npz`: the port's checkpoint with every query's person logit raised
    by 3 and the last box layer's kernel drawn, so that the tracker sees
    detections all over the frame."""
    from trackformer_tpu import native as jnative
    from trackformer_tpu.cli import track as jax_track
    from trackformer_tpu.cli.train import main as jax_main
    from trackformer_tpu_torch import native
    from trackformer_tpu_torch.cli import track as port_track

    params = load_params_npz(trained[0] / "checkpoint_params.npz")
    noise = np.random.RandomState(1)
    for i in range(2):
        head = params["params"][f"class_embed_{i}"]
        head["bias"] = head["bias"].copy()
        head["bias"][0] = 3.0
        last = params["params"][f"bbox_embed_{i}"]["layer_2"]
        last["kernel"] = (0.05 * noise.randn(*last["kernel"].shape)
                          ).astype(np.float32)
    shared = tmp_path_factory.mktemp("shared") / "shared.npz"
    save_params_npz(params, shared)
    argv = ["with", *TINY, *data[0], "eval_only=true", "tracking_eval=true",
            f"resume={shared}"]
    with pytest.MonkeyPatch.context() as mp:
        # both trackers with 8 track slots (track.yaml's 150 cost the JAX
        # tracker's compile ~100 s here)
        for cli in (jax_track, port_track):
            mp.setattr(cli, "main", lambda a, *r, _main=cli.main, **k: _main(
                a + ["tpu.max_tracks=8"], *r, **k))
        got = main(argv, device="cpu")
        mp.setattr(jnative, "_LIB", native.load())
        mp.setattr(jnative, "_TRIED", True)
        want = jax_main(argv)
    return got, want


def test_eval_only_matches_the_jax_cli(both_evals):
    got, want = both_evals
    assert set(got) == set(want)
    np.testing.assert_allclose(got["coco_eval_bbox"], want["coco_eval_bbox"],
                               atol=1e-6, rtol=0)
    for key in set(want) - {"coco_eval_bbox", "MOTA", "IDF1"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_tracking_eval_matches_the_jax_cli(both_evals):
    got, want = both_evals
    assert {"MOTA", "IDF1"} <= set(got)
    assert got["MOTA"] == want["MOTA"] and got["IDF1"] == want["IDF1"]
    assert got["MOTA"] < 0             # the tracker reported false positives


def test_unported_options_raise(data, capsys):
    """Several model-parallel processes (item 8) raise; three-frame
    training, backprop through the previous frames and the panoptic data
    run (`test_torch_train_extras.py`, `test_torch_panoptic.py`), and
    `tpu.remat` is applied without a word."""
    base = ["with", *TINY, *data[0], "eval_only=true", "tracking_eval=false"]
    with pytest.raises(NotImplementedError, match="item 8"):
        main(base + ["tpu.model_parallel=2"], device="cpu")
    if not torch.cuda.is_available():
        # the card is the default device; the CPU only when asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(base)
    main(base + ["tpu.remat=true", "tpu.eval_subset=2",
                 "track_prev_prev_frame=true"], device="cpu")
    printed = capsys.readouterr().out
    assert "remat" not in printed
    assert "EVAL SUBSET: 2/8 images" in printed


def test_load_mask_head_from_model(data, tmp_path, capsys):
    """`with mots20` (vanilla DETR with masks) takes every `mask_head` /
    `bbox_attention` tensor of a seeded `.npz` in the JAX layout (and no
    other) into its train state; `freeze_detr` is announced as having no
    effect."""
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.utils.checkpoint import save_model_npz
    from trackformer_tpu_torch.utils.config import (FlagshipConfig,
                                                    load_config)
    tiny = {"enc_layers": 1, "dec_layers": 1, "hidden_dim": 128,
            "nheads": 8, "dim_feedforward": 64, "num_queries": 8,
            "tpu.compute_dtype": "float32"}
    cfg = FlagshipConfig.from_config(load_config("train.yaml", ["mots20"],
                                                 tiny))
    donor, _ = build_model(cfg, "cpu", torch.Generator().manual_seed(5))
    save_model_npz(donor, tmp_path / "mask_head.npz", cfg)
    state = main(["with", "mots20", *(f"{k}={v}" for k, v in tiny.items()),
                  *data[0], "resume=", "epochs=0", "freeze_detr=true",
                  f"load_mask_head_from_model={tmp_path / 'mask_head.npz'}"],
                 device="cpu")
    fresh, _ = build_model(cfg, "cpu", torch.Generator().manual_seed(42))
    want, other = donor.state_dict(), fresh.state_dict()
    heads = [k for k in want if k.startswith(("mask_head.",
                                               "bbox_attention."))]
    assert len(heads) == 4 + 2 * 5 + 2 * 5 + 2 * 3 + 2   # lay, gn, adapter
    for key, value in state.params.items():
        ref = want[key] if key in heads else other[key]
        assert torch.equal(value, ref.float()), key
    printed = capsys.readouterr().out
    assert "LOADED MASK HEAD" in printed and "freeze_detr: no effect" in \
        printed
