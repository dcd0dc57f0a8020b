"""The port's tracking CLI (trackformer_tpu_torch.cli.track) on the CPU:
(a) perfect results loaded from files give MOTA = IDF1 = 1; (b) live,
against the JAX CLI: tiny JAX weights saved as an `.npz` with their
`config.yaml` go through both CLIs over the same two sequences, with the
same tracker settings and the same native preprocessing (the JAX package's
native binding pointed at the library the port built), one sequence at a
time and two in lockstep; (c) rendering and interpolation write the frame
directory; (d) a PNG sequence and a DEMO image folder through the port's
CLI alone.

Tolerances: the two models differ by float32 summation order (~1e-5 in
scores); the tracker thresholds sit clear of this model's scores, so the
result files hold the same (frame, id) rows and boxes within 1e-3 px, and
the MOT summaries are equal.
"""
import csv
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from trackformer_tpu import native as jnative
from trackformer_tpu.cli.track import main as jax_main
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.utils.checkpoint import save_params_npz
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch import native
from trackformer_tpu_torch.cli.track import main

sys.path.insert(0, str(Path(__file__).parent))
from synth_data import make_synth_mot  # noqa: E402

torch.set_num_threads(1)

NAMED = ["deformable", "tracking", "multi_frame"]
TINY = {"enc_layers": 1, "dec_layers": 1, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8, "dataset": "mot",
        "img_transform.max_size": 170, "img_transform.val_width": 128,
        "tpu.compute_dtype": "float32"}
SEQS = ["MOT17-02-FRCNN", "MOT17-04-FRCNN"]
# the flagship tracker settings with the score thresholds moved into this
# random model's score range, clear of every score it gives
TRACKER = ["tracker_cfg.detection_obj_score_thresh=0.47",
           "tracker_cfg.track_obj_score_thresh=0.47", "tpu.max_tracks=8"]


def _rename(root: Path, src: str, dst: str) -> None:
    import configparser
    (root / "train" / src).rename(root / "train" / dst)
    ini = configparser.ConfigParser()
    ini.read(root / "train" / dst / "seqinfo.ini")
    ini["Sequence"]["name"] = dst
    with open(root / "train" / dst / "seqinfo.ini", "w") as f:
        ini.write(f)


@pytest.fixture(scope="module")
def mot17_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthmot17") / "MOT17"
    make_synth_mot(root, n_seqs=2, n_frames=4)
    for k, name in enumerate(SEQS):
        _rename(root, f"SYN-{k + 1:02d}", name)
    return root.parent


def _gt_as_results(seq):
    results = {}
    for f_idx in range(len(seq)):
        for tid, box in seq.data[f_idx]["gt"].items():
            results.setdefault(tid - 1, {})[f_idx] = {
                "bbox": np.asarray(box, np.float32), "score": 1.0}
    return results


def test_loaded_results_perfect_mota(mot17_root, tmp_path):
    from trackformer_tpu_torch.datasets.tracking import TrackDatasetFactory
    seq = TrackDatasetFactory(SEQS[0], root_dir=str(mot17_root),
                              img_transform=None)[0]
    res_dir = tmp_path / "results"
    seq.write_results(_gt_as_results(seq), str(res_dir))
    summary = main([
        "with", f"dataset_name={SEQS[0]}", f"data_root_dir={mot17_root}",
        f"load_results_dir={res_dir}", "obj_detect_checkpoint_file=null",
        "output_dir=null"], device="cpu")
    overall = summary["OVERALL"]
    assert overall["mota"] == pytest.approx(1.0)
    assert overall["idf1"] == pytest.approx(1.0)
    assert overall["num_switches"] == 0


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Tiny JAX weights in an `.npz` with their `config.yaml`: a person
    detector whose class-0 logits sit near 0, with varied boxes."""
    model_dir = tmp_path_factory.mktemp("model")
    cfg = load_config("train.yaml", NAMED, TINY)
    with open(model_dir / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    jmodel = jax_build_model(nested_namespace(cfg))[0]
    batch = JFrameBatch.from_images(jnp.zeros((1, 64, 64, 3)),
                                    jnp.array([[64, 64]]))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                  batch))
    noise = np.random.RandomState(1)
    for i in range(TINY["dec_layers"]):
        head = params["params"][f"class_embed_{i}"]
        head["bias"] = head["bias"].copy()
        head["bias"][0] = 0.0
        last = params["params"][f"bbox_embed_{i}"]["layer_2"]
        last["kernel"] = (0.05 * noise.randn(*last["kernel"].shape)
                          ).astype(np.float32)
    save_params_npz(params, model_dir / "checkpoint.npz")
    return model_dir / "checkpoint.npz"


def read_rows(path: Path) -> dict:
    """A result file -> {(frame, id): box as float64}."""
    with open(path) as f:
        return {(int(r[0]), int(r[1])): np.array(r[2:6], np.float64)
                for r in csv.reader(f)}


@pytest.mark.parametrize("batch_sequences", [1, 2])
def test_live_matches_the_jax_cli(mot17_root, checkpoint, tmp_path,
                                  monkeypatch, batch_sequences):
    monkeypatch.setattr(jnative, "_LIB", native.load())
    monkeypatch.setattr(jnative, "_TRIED", True)
    argv = ["with", "dataset_name=[" + ",".join(SEQS) + "]",
            f"data_root_dir={mot17_root}",
            f"obj_detect_checkpoint_file={checkpoint}",
            f"tpu.batch_sequences={batch_sequences}", *TRACKER]
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
    assert (tmp_path / "port" / "track.yaml").exists()


def test_render_and_interpolate(mot17_root, checkpoint, tmp_path):
    out = tmp_path / "out"
    main(["with", f"dataset_name={SEQS[0]}", f"data_root_dir={mot17_root}",
          f"obj_detect_checkpoint_file={checkpoint}", f"output_dir={out}",
          "write_images=pretty", "interpolate=true", *TRACKER],
         device="cpu")
    assert (out / f"{SEQS[0]}.txt").exists()
    frames = sorted(p.name for p in (out / SEQS[0]).iterdir())
    assert frames == [f"{i:06d}.jpg" for i in range(1, 5)]


def test_png_sequence_and_demo_folder(tmp_path, checkpoint):
    from PIL import Image

    mot = tmp_path / "data" / "MOT17"
    make_synth_mot(mot, n_seqs=1, n_frames=3)
    seq = mot / "train" / "SYN-01"
    for jpg in sorted((seq / "img1").glob("*.jpg")):
        with Image.open(jpg) as im:
            im.save(jpg.with_suffix(".png"))
        jpg.unlink()
    ini = (seq / "seqinfo.ini").read_text().replace(".jpg", ".png")
    (seq / "seqinfo.ini").write_text(ini)
    _rename(mot, "SYN-01", SEQS[0])
    out = tmp_path / "out"
    summary = main(["with", f"dataset_name={SEQS[0]}",
                    f"data_root_dir={tmp_path / 'data'}",
                    f"obj_detect_checkpoint_file={checkpoint}",
                    f"output_dir={out}", *TRACKER], device="cpu")
    assert summary["OVERALL"]["num_objects"] == 3 * 2
    assert read_rows(out / f"{SEQS[0]}.txt")

    assert main(["with", "dataset_name=DEMO",
                 f"data_root_dir={mot / 'train' / SEQS[0] / 'img1'}",
                 f"obj_detect_checkpoint_file={checkpoint}",
                 f"output_dir={out}", *TRACKER], device="cpu") is None
    assert read_rows(out / "img1.txt")


def test_unported_options_raise(mot17_root, checkpoint):
    base = ["with", f"dataset_name={SEQS[0]}", f"data_root_dir={mot17_root}",
            f"obj_detect_checkpoint_file={checkpoint}"]
    # attention maps are vanilla DETR's, as in the JAX package
    with pytest.raises(ValueError, match="vanilla DETR"):
        main(base + ["generate_attention_maps=true"], device="cpu")
    if not torch.cuda.is_available():
        # the card is the default device; the CPU only when asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(base)
