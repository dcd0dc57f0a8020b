"""The port's offline tools and last host modules held against the JAX
package's on the CPU, on seeded data:

  * the original-checkpoint loader (`tools/convert_weights.py` of the
    port): a `.pth` in the original layout, made from seeded JAX params by
    inverting the JAX tool's `torch_key_for` transforms
    (`test_convert_weights.inverse_torch_dict`), loads onto the port's
    model bit for bit as the JAX tool's `convert` -> `.npz` -> the port's
    `load_model_npz` does, with an empty coverage report; a foreign key,
    a missing one and a wrong shape each show in it;
  * COCO keypoints evaluation (`datasets/coco_eval.py`): the 10 statistics
    and the result list equal the JAX `CocoEvaluator`'s to 1e-12;
  * the CrowdHuman converter writes the JAX tool's JSON, byte for byte;
  * `parse_mot_results_to_tex` prints the JAX tool's lines;
  * `track_param_search` sweeps the JAX tool's grid and picks its choice,
    with both tracking CLIs stubbed to the same seeded metrics;
  * `plot_utils`: the parsed, smoothed series, and the lines each plot
    draws, are the JAX module's;
  * `make_video` stitches frames through `write_video`.
"""
import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from synth_data import make_synth_mot  # noqa: E402
from test_convert_weights import inverse_torch_dict  # noqa: E402
from test_torch_variants import jax_params  # noqa: E402
from trackformer_tpu.datasets.coco_eval import \
    CocoEvaluator as JaxCocoEvaluator  # noqa: E402
from trackformer_tpu.models import build_model as jax_build_model  # noqa
from trackformer_tpu.utils import plot_utils as jplot  # noqa: E402
from trackformer_tpu.utils.checkpoint import (flatten_params,  # noqa: E402
                                              save_params_npz,
                                              unflatten_params)
from trackformer_tpu.utils.config import (load_config,  # noqa: E402
                                          nested_namespace)
from trackformer_tpu_torch.datasets.coco_eval import CocoEvaluator  # noqa
from trackformer_tpu_torch.models import build_model  # noqa: E402
from trackformer_tpu_torch.tools import (convert_weights,  # noqa: E402
                                         generate_coco_from_crowdhuman,
                                         make_video,
                                         parse_mot_results_to_tex,
                                         track_param_search)
from trackformer_tpu_torch.utils import plot_utils  # noqa: E402
from trackformer_tpu_torch.utils.checkpoint import load_model_npz  # noqa
from trackformer_tpu_torch.utils.config import FlagshipConfig  # noqa: E402

TOOLS = Path(__file__).parent.parent / "tools"
TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8,
        "tpu.compute_dtype": "float32"}


def load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def original_checkpoint(tmp_path_factory):
    """A `.pth` in the original layout of the tiny flagship, its JAX
    params, and the config."""
    cfg = load_config("train.yaml", ["deformable", "tracking", "multi_frame"],
                      TINY)
    jmodel = jax_build_model(nested_namespace(cfg))[0]
    params = jax_params(jmodel, seed=3)
    state = inverse_torch_dict(flatten_params(params))
    # as the original's DDP training saves it, with the run's other entries
    path = tmp_path_factory.mktemp("pth") / "checkpoint.pth"
    torch.save({"model": {"module." + k: torch.from_numpy(np.array(v))
                          for k, v in state.items()},
                "epoch": 3, "args": {"lr": 2e-4}}, path)
    return path, params, state, cfg


def test_pth_loader_equals_the_jax_tools_path(original_checkpoint,
                                              tmp_path):
    path, params, state, cfg = original_checkpoint
    port_cfg = FlagshipConfig.from_config(cfg)
    flat = load_tool("convert_weights").convert(
        state, flatten_params(params), verbose=False)
    save_params_npz(unflatten_params(flat), tmp_path / "jax.npz")
    via_jax = build_model(port_cfg, "cpu")[0]
    load_model_npz(via_jax, tmp_path / "jax.npz")

    direct = build_model(port_cfg, "cpu",
                         torch.Generator().manual_seed(1))[0]
    report = convert_weights.load_pth_state(
        direct, convert_weights.read_pth(path), verbose=False)
    assert report.empty, report
    want = via_jax.state_dict()
    got = direct.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    # the CLI writes the same weights, as an .npz and a state dict
    convert_weights.main([str(path), str(tmp_path / "out.npz"),
                          "--config", _dump(cfg, tmp_path),
                          "--state-dict", str(tmp_path / "out.pt")])
    again = build_model(port_cfg, "cpu")[0]
    load_model_npz(again, tmp_path / "out.npz")
    saved = torch.load(tmp_path / "out.pt", weights_only=True)
    for k, v in want.items():
        assert torch.equal(again.state_dict()[k], v), k
        assert torch.equal(saved[k], v), k


def _dump(cfg, tmp_path):
    import yaml
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_pth_loader_reports_what_it_left_out(original_checkpoint):
    _, _, state, cfg = original_checkpoint
    state = dict(state)
    dropped = "transformer.level_embed"
    del state[dropped]
    wrong = "class_embed.0.bias"
    state[wrong] = np.zeros(3, np.float32)
    state["detr.backbone.0.body.bn1.num_batches_tracked"] = np.array(4)
    model = build_model(FlagshipConfig.from_config(cfg), "cpu")[0]
    before = model.state_dict()[wrong].clone()
    report = convert_weights.load_pth_state(model, state, verbose=False)
    assert report.unmapped == [dropped]
    assert report.mismatched == [wrong]
    assert report.unused == ["backbone.0.body.bn1.num_batches_tracked",
                             wrong]
    assert torch.equal(model.state_dict()[wrong], before)


def keypoint_data(seed=0, n_images=4):
    """Ground truth and detections with 17 keypoints: some unlabelled
    keypoints, a ground truth with none labelled, detections near and far
    from their ground truth, over the medium and large ranges."""
    rng = np.random.RandomState(seed)
    anns, preds = {}, {}
    for img in range(n_images):
        anns[img], boxes, kps, scores = [], [], [], []
        for j in range(3):
            x, y = rng.uniform(0, 300, 2)
            w, h = rng.uniform(40, 160, 2)
            kp = np.stack([x + rng.uniform(0, w, 17), y + rng.uniform(0, h, 17),
                           rng.choice([0, 1, 2], 17, p=[.2, .3, .5])], 1)
            if img == 1 and j == 2:
                kp[:, 2] = 0
            anns[img].append({"bbox": [x, y, w, h], "category_id": 1,
                              "iscrowd": 0, "area": w * h,
                              "keypoints": kp.reshape(-1).tolist(),
                              "num_keypoints": int((kp[:, 2] > 0).sum())})
            for shift in (rng.uniform(0, 4), rng.uniform(10, 40)):
                det = kp.copy()
                det[:, :2] += shift * rng.randn(17, 2)
                det[:, 2] = 1
                boxes.append([x, y, x + w, y + h])
                kps.append(det)
                scores.append(rng.uniform())
        preds[img] = {"boxes": np.array(boxes), "keypoints": np.array(kps),
                      "scores": np.array(scores),
                      "labels": np.ones(len(scores), np.int64)}

    class GT:
        anns_by_image = anns
        images = {i: {"height": 480, "width": 640} for i in anns}
    return GT(), preds


def test_keypoint_stats_match_jax():
    gt, preds = keypoint_data()
    ours = CocoEvaluator(gt, ("keypoints",))
    theirs = JaxCocoEvaluator(gt, ("keypoints",))
    for ev in (ours, theirs):
        ev.update(preds)
    with redirect_stdout(io.StringIO()):
        got, want = ours.summarize(), theirs.summarize()
    assert len(got["keypoints"]) == 10
    np.testing.assert_allclose(got["keypoints"], want["keypoints"],
                               rtol=1e-12, atol=1e-12)
    assert 0.0 < got["keypoints"][0] < 1.0
    assert ours.prepare(preds, "keypoints") == \
        theirs.prepare(preds, "keypoints")


def test_crowdhuman_converter_writes_the_jax_json(tmp_path):
    rng = np.random.RandomState(2)
    recs = [{"ID": f"img_{i}", "gtboxes": [
        {"tag": tag, "fbox": rng.randint(0, 200, 4).tolist(),
         "extra": ({"ignore": 1} if rng.rand() < .3 else {})}
        for tag in rng.choice(["person", "mask"], rng.randint(0, 5))]}
        for i in range(6)]
    outs = []
    for who, gen in (("jax", load_tool("generate_coco_from_crowdhuman")
                      .generate),
                     ("port", generate_coco_from_crowdhuman.generate)):
        root = tmp_path / who
        root.mkdir()
        for split in ("train", "trainval"):
            with open(root / f"annotation_{split}.odgt", "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in recs)
            with redirect_stdout(io.StringIO()):
                gen(split, str(root))
        outs.append([(root / "annotations" / f"{n}.json").read_bytes()
                     for n in ("train", "train_val")])
    assert outs[0] == outs[1]
    assert json.loads(outs[1][0])["annotations"]


def test_parse_mot_results_to_tex_prints_the_jax_lines(tmp_path,
                                                       monkeypatch):
    import configparser

    from trackformer_tpu_torch.datasets.tracking import TrackDatasetFactory

    root = tmp_path / "MOT17"
    make_synth_mot(root, n_seqs=1, n_frames=5)
    (root / "train" / "SYN-01").rename(root / "train" / "MOT17-02-FRCNN")
    ini = configparser.ConfigParser()
    ini.read(root / "train" / "MOT17-02-FRCNN" / "seqinfo.ini")
    ini["Sequence"]["name"] = "MOT17-02-FRCNN"
    with open(root / "train" / "MOT17-02-FRCNN" / "seqinfo.ini", "w") as f:
        ini.write(f)
    seq = TrackDatasetFactory("MOT17-02-FRCNN", root_dir=str(tmp_path),
                              img_transform=None)[0]
    rng = np.random.RandomState(5)
    dirs = []
    for run, noise in (("perfect", 0.0), ("noisy", 6.0)):
        results = {}
        for f_idx in range(len(seq)):
            for tid, box in seq.data[f_idx]["gt"].items():
                if noise and rng.rand() < 0.2:
                    continue
                box = np.asarray(box, np.float32) + noise * rng.randn(4)
                results.setdefault(tid - 1, {})[f_idx] = {
                    "bbox": box.astype(np.float32), "score": 1.0}
        seq.write_results(results, str(tmp_path / run))
        dirs.append(str(tmp_path / run))
    dirs.append(str(tmp_path / "empty"))
    args = [*dirs, "--dataset", "MOT17-02-FRCNN", "--data-root",
            str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["prog", *args])
    buf = io.StringIO()
    with redirect_stdout(buf):
        load_tool("parse_mot_results_to_tex").main()
        lines = parse_mot_results_to_tex.main(args)
    printed = buf.getvalue().splitlines()
    assert printed[:len(lines)] == lines == printed[len(lines):]
    assert lines[2].startswith("perfect & 100.0 & 100.0")
    assert not lines[3].startswith("noisy & 100.0")


def test_track_param_search_matches_the_jax_tool(monkeypatch):
    """Both tools, with their tracking CLI stubbed to the same seeded
    metrics of each combination, run the same grid and pick the same
    best."""
    calls = {"jax": [], "port": []}

    def fake(who):
        def main(argv, **kw):
            calls[who].append(list(argv))
            key = sorted(a for a in argv if a.startswith("tracker_cfg"))
            seed = sum(map(ord, "".join(key)))
            rng = np.random.RandomState(seed)
            return {"OVERALL": {"mota": float(rng.rand()),
                                "idf1": float(rng.rand())}}
        return main

    class FakeCli:
        main = staticmethod(fake("jax"))

    monkeypatch.setitem(sys.modules, "trackformer_tpu.cli.track", FakeCli)
    import trackformer_tpu.cli as cli_pkg
    monkeypatch.setattr(cli_pkg, "track", FakeCli, raising=False)
    from trackformer_tpu_torch.cli import track as port_track
    monkeypatch.setattr(port_track, "main", fake("port"))
    with redirect_stdout(io.StringIO()):
        want = load_tool("track_param_search").main(["with", "dataset_name=X"])
        got = track_param_search.main(["with", "dataset_name=X"],
                                      device="cpu")
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 9
    assert got == want and got["mota"] == max(
        track_param_search.search(
            ["with", "dataset_name=X"], fake("port"))["all"],
        key=lambda r: r["mota"])["mota"]


@pytest.fixture
def logs(tmp_path):
    rng = np.random.RandomState(8)
    dirs = []
    for run in ("a", "b"):
        d = tmp_path / run / "vis"
        d.mkdir(parents=True)
        rows = [{"epoch": e, "train_loss": float(rng.rand()),
                 "test_loss": float(rng.rand()), "AP": float(rng.rand()),
                 "coco_eval_bbox": [0.1] * 12} for e in range(6)]
        rows.insert(2, {"epoch": 9})
        (d / "epoch_metrics.jsonl").write_text(
            "\n".join(json.dumps(r) for r in rows) + "\n\n")
        dirs.append(tmp_path / run)
    # a log.txt directory, as the original writes it
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "log.txt").write_text(
        "\n".join(json.dumps({"train_loss": float(v)})
                  for v in rng.rand(4)))
    return dirs + [tmp_path / "c"]


@pytest.mark.parametrize("com", [0, 0.5, 3])
def test_plot_utils_parses_logs_as_jax(logs, com):
    rows = plot_utils.read_logs(logs)
    assert rows == [jplot._read_jsonl(p / "vis/epoch_metrics.jsonl")
                    if (p / "vis/epoch_metrics.jsonl").exists()
                    else jplot._read_jsonl(p / "log.txt") for p in logs]
    values = np.random.RandomState(1).rand(20)
    np.testing.assert_array_equal(plot_utils.ewm(values, com),
                                  jplot._ewm(values, com))
    fields = ("loss", "AP", "coco_eval_bbox")
    fig, axs = plot_utils.plot_logs(logs, fields, ewm_col=com)
    jfig, jaxs = jplot.plot_logs(logs, fields, ewm_col=com)
    for ax, jax_ in zip(axs, jaxs):
        got = [(line.get_linestyle(), line.get_ydata()) for line in
               ax.get_lines()]
        want = [(line.get_linestyle(), line.get_ydata()) for line in
                jax_.get_lines()]
        assert len(got) == len(want)
        for (gs, gy), (ws, wy) in zip(got, want):
            assert gs == ws
            np.testing.assert_array_equal(gy, wy)
    assert plot_utils.log_series(rows[0], "loss", com).keys() == \
        {"train", "test"}
    assert plot_utils.log_series(rows[0], "coco_eval_bbox") == {}


def test_plot_precision_recall_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    files = []
    for i in range(2):
        path = tmp_path / f"eval_{i}.npz"
        np.savez(path, precision=rng.rand(10, 101, 3, 1, 1),
                 scores=rng.rand(10, 101, 3, 1, 1),
                 recall=rng.rand(10, 3, 1, 1),
                 recThrs=np.linspace(0, 1, 101))
        files.append(path)
    with redirect_stdout(io.StringIO()) as ours:
        _, axs = plot_utils.plot_precision_recall(files)
    with redirect_stdout(io.StringIO()) as theirs:
        _, jaxs = jplot.plot_precision_recall(files)
    assert ours.getvalue() == theirs.getvalue()
    for ax, jax_ in zip(axs, jaxs):
        for a, b in zip(ax.get_lines(), jax_.get_lines()):
            np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())


def test_make_video_stitches_the_frames(tmp_path):
    from PIL import Image
    for i in range(3):
        Image.fromarray(np.full((8, 6, 3), 60 * i, np.uint8)).save(
            tmp_path / f"{i:06d}.jpg")
    with redirect_stdout(io.StringIO()):
        written = make_video.main([str(tmp_path), str(tmp_path / "v.mp4"),
                                   "--fps", "5"])
    assert Path(written).exists() and Path(written).stat().st_size > 0


def test_plots_say_that_matplotlib_is_missing(logs, monkeypatch):
    """Where matplotlib does not import (the card's machine) the plots
    raise an ImportError naming it; the parsing runs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_utils.plot_logs(logs)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_utils.plot_precision_recall([])
    assert plot_utils.log_series(plot_utils.read_logs(logs)[0], "AP")
