"""The port (trackformer_tpu_torch) and chip_smoke.py must run where JAX
and flax are absent, as on the machine with the card: every module of the
package imports, and tiny tracker runs of both encoder modes (exact MSDA,
and the TPU-fast windowed mode with the cached memory, through `Tracker`
and `BatchedTracker`; the exact mode also on route "v4" and under
`MSDA_DEC_SKIP`), the public MSDA ops that no route calls, one
two-frame training step of the exact mode, a checkpoint round trip (an
`.npz` in the JAX layout and the train state through `CheckpointManager`),
one `evaluate`, the tracking CLI over a small PNG sequence (its
configs, the native preprocessing, the port's PNG reader), and the MOT ->
COCO converter over a small JPEG sequence followed by one debug epoch of
the training CLI on its JSON (the datasets, the training transforms, the
loader, a validation), the MOTS20 recipe (vanilla DETR with masks: the
tracking CLI over a MOTS20 sequence, the converter's MOTS mode and a debug
epoch of `with mots20` with a loaded mask head), the single-frame
Deformable DETR family (exact and
windowed encoder, shared heads, in a `Tracker` and a detection train
step), the rest of the family's switches (two-stage in a detection train
step, the dense decoder, merged frame features, the exact cached memory,
5 levels, ResNet-101 with DC5, window side 16, each in a `Tracker`), both
agreement tools and a `fast_w16` probe at the `small` scale, vanilla
DETR's attention maps through the tracking CLI, COCO panoptic's
`eval_only` with PQ, the tracker's soft reset and a three-frame step
through the previous frames with remat go through on the CPU, in a subprocess in which
importing jax, jaxlib or flax raises. The port keeps its own copies of
what it needs from the JAX side of the repository: the same run records
every file opened under `trackformer_tpu/` or `tools/`, and there must be
none."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

BLOCKED_RUN = r'''
import importlib, importlib.abc, importlib.util, os, pkgutil, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, NoJax())
JAX_SIDE = [os.path.realpath(d) + os.sep for d in ("trackformer_tpu", "tools")]
opened_outside = []

def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        path = os.path.realpath(os.fsdecode(args[0]))
        if any(path.startswith(d) for d in JAX_SIDE):
            opened_outside.append(path)

sys.addaudithook(audit)
import numpy as np
import torch
import trackformer_tpu_torch
for mod in pkgutil.walk_packages(trackformer_tpu_torch.__path__,
                                 "trackformer_tpu_torch."):
    importlib.import_module(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)

from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import BatchedTracker, Tracker
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)
tiny = dict(dec_layers=1, hidden_dim=96, nheads=4, dim_feedforward=64,
            num_queries=8, compute_dtype="float32", max_tracks=4)
img = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(1))
blob = {"batch": FrameBatch.from_images(img),
        "orig_size": torch.tensor([[64, 96]])}
for cfg in (FlagshipConfig().replace(enc_layers=1, **tiny),
            FlagshipConfig.tpu_fast(enc_layers=2, **tiny)):
    model, post = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    tracker_cfg = {**cfg.tracker_cfg, "max_tracks": 4}
    tracker = Tracker(model, post, tracker_cfg, cfg.hidden_dim,
                      cfg.num_queries)
    for _ in range(2):
        tracker.step(blob)
    assert tracker.frame_index == 2
    if not cfg.cached_prev_memory:
        exact_tracker = tracker
    else:
        batched = BatchedTracker(model, post, tracker_cfg, cfg.hidden_dim,
                                 cfg.num_queries)
        assert len(batched.run([[blob, blob], [blob, blob]])) == 2

# the other routes of the MSDA op (kernel v4 for the encoder's levels, then
# for every call with few queries), and the public ops that no route calls
from trackformer_tpu_torch.ops import msda, msda_pallas, msda_patch
msda.DENSE_CELL_BUDGET = 0
msda.PALLAS_SKIP_IMPL, msda.PALLAS_V2_MIN_QUERIES = "v4", 100
exact_tracker.step(blob)
msda.PALLAS_SKIP_IMPL, msda.MSDA_DEC_SKIP = "v5", True
msda.PALLAS_DENSE_MAX_CELLS = 0
exact_tracker.step(blob)
assert exact_tracker.frame_index == 4
msda.MSDA_DEC_SKIP = False
shapes = ((8, 12), (4, 6))
value, loc = torch.randn(1, 120, 2, 4), torch.rand(1, 120, 2, 2, 3, 2)
attn = torch.rand(1, 120, 2, 2, 3)
want = msda.ms_deform_attn(value, shapes, loc, attn)
for op in (msda_pallas.ms_deform_attn_pallas, msda_patch.msda_patch_v6):
    assert torch.allclose(op(value, shapes, loc, attn).reshape(want.shape),
                          want, atol=1e-5)

from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.structures import empty_targets

cfg = FlagshipConfig().replace(enc_layers=1, **tiny)
gen = torch.Generator().manual_seed(0)
model, crit, _, track = build_model(cfg, "cpu", gen, train=True)
optimizer = make_optimizer(cfg, model)
state = TrainState.create(model, optimizer)
targets = empty_targets(1, 3, "cpu")
targets.valid[:, :2] = True
targets.boxes[:, :2] = torch.tensor([[.3, .3, .2, .2], [.6, .6, .2, .3]])
targets.track_ids[:, :2] = torch.arange(2, dtype=torch.int32)
pack = {"batch": blob["batch"], "targets": targets,
        "prev_batch": blob["batch"], "prev_targets": targets}
step = make_train_step(model, crit, optimizer, track, tracking=True)
state, metrics = step(state, pack, gen)
assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))

# checkpoints: the weights through an .npz in the JAX layout and the train
# state through the manager, into a fresh model; then one evaluate
import tempfile
from trackformer_tpu_torch.engine.loop import evaluate
from trackformer_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    load_model_npz,
                                                    save_model_npz)
out_dir = tempfile.mkdtemp()
save_model_npz(model, out_dir + "/w.npz", cfg)
fresh, fresh_crit, fresh_post, _ = build_model(cfg, "cpu", train=True)
load_model_npz(fresh, out_dir + "/w.npz")
assert all(torch.equal(fresh.state_dict()[k], v)
           for k, v in model.state_dict().items())
CheckpointManager(out_dir + "/run").save(state, 1, {"AP": 0.5}, cfg)
fresh_state = TrainState.create(fresh, make_optimizer(cfg, fresh))
fresh_state, epoch = CheckpointManager(out_dir + "/run").restore(
    fresh_state, fresh)
assert epoch == 1 and fresh_state.step == 1

class GT:
    anns_by_image = {0: [{"bbox": [20.0, 20.0, 18.0, 12.0],
                          "category_id": 1, "iscrowd": 0, "area": 216.0}]}

targets.orig_size[:] = torch.tensor([64, 96], dtype=torch.int32)
stats = evaluate(fresh, fresh_crit, {"bbox": fresh_post},
                 [{"batch": blob["batch"], "targets": targets}],
                 lambda p: p, GT(), cfg)
assert len(stats["coco_eval_bbox"]) == 12 and "loss_ce" in stats

# the serving entry point over a small PNG sequence (written by
# chip_smoke's own encoder), from a tiny checkpoint and its config.yaml
from pathlib import Path
from trackformer_tpu_torch.cli.track import main as track_main
from trackformer_tpu_torch.utils.config import dump_config, load_config
data = Path(out_dir) / "data"
chip_smoke.write_mot_sequences(data, ["MOT17-02-FRCNN"], 2, hw=(54, 96))
train_cfg = load_config("train.yaml", ["deformable", "tracking", "multi_frame"],
                        {"enc_layers": 1, "dec_layers": 1, "hidden_dim": 96,
                         "nheads": 4, "dim_feedforward": 64, "num_queries": 8,
                         "img_transform.val_width": 64,
                         "img_transform.max_size": 114,
                         "tpu.compute_dtype": "float32"})
cli_cfg = FlagshipConfig.from_config(train_cfg)
cli_model, _ = build_model(cli_cfg, "cpu", torch.Generator().manual_seed(0))
save_model_npz(cli_model, out_dir + "/cli/checkpoint.npz", cli_cfg)
dump_config(train_cfg, out_dir + "/cli/config.yaml")
summary = track_main(["with", "dataset_name=MOT17-02-FRCNN",
                      f"data_root_dir={data}",
                      f"obj_detect_checkpoint_file={out_dir}/cli/checkpoint.npz",
                      f"output_dir={out_dir}/cli_out", "tpu.max_tracks=4"],
                     device="cpu")
assert summary["OVERALL"]["num_objects"] == 2 * 3
assert os.path.exists(out_dir + "/cli_out/MOT17-02-FRCNN.txt")

# the training entry point: the converter over JPEG sequences, then one
# debug epoch of the CLI on its JSON
from trackformer_tpu_torch.cli.train import main as train_main
from trackformer_tpu_torch.tools.generate_coco_from_mot import main as convert
train_data = Path(out_dir) / "train_data"
chip_smoke.write_mot_sequences(train_data, ["MOT17-02-FRCNN"], 3,
                               hw=(54, 96), ext="jpg")
convert(["mot17", "--data-root", str(train_data / "MOT17")])
state = train_main(
    ["with", "deformable", "tracking", "multi_frame", "enc_layers=1",
     "dec_layers=1", "hidden_dim=96", "nheads=4", "dim_feedforward=64",
     "num_queries=8", "dataset=mot", f"mot_path_train={train_data}/MOT17",
     f"mot_path_val={train_data}/MOT17", "train_split=mot17_train_coco",
     "val_split=mot17_train_coco", "img_transform.val_width=64",
     "img_transform.max_size=114", "tpu.image_buckets=[[128,128]]",
     "tpu.max_objects=4", "tpu.compute_dtype=float32", "tracking_eval=false",
     "epochs=1", "debug=true", "batch_size=1",
     f"output_dir={out_dir}/train_run"], device="cpu")
assert state.step == 2
assert os.path.exists(out_dir + "/train_run/checkpoint_params.npz")
# two-stage (the `_enc` losses) and the dense decoder through the training
# CLI, the latter's checkpoint through the tracking CLI
for extra, run in ((["two_stage=true"], "two_stage"),
                   (["tpu.decoder_attention=dense"], "dense")):
    state = train_main(
        ["with", "deformable", "tracking", "multi_frame", "enc_layers=1",
         "dec_layers=1", "hidden_dim=96", "nheads=4", "dim_feedforward=64",
         "num_queries=8", "dataset=mot", f"mot_path_train={train_data}/MOT17",
         f"mot_path_val={train_data}/MOT17", "train_split=mot17_train_coco",
         "val_split=mot17_train_coco", "img_transform.val_width=64",
         "img_transform.max_size=114", "tpu.image_buckets=[[128,128]]",
         "tpu.max_objects=4", "tpu.compute_dtype=float32",
         "tracking_eval=false", "epochs=1", "debug=true", "batch_size=1",
         *extra, f"output_dir={out_dir}/{run}_run"], device="cpu")
    assert state.step == 2
assert track_main(["with", "dataset_name=MOT17-02-FRCNN",
                   f"data_root_dir={data}",
                   f"obj_detect_checkpoint_file={out_dir}/dense_run/"
                   "checkpoint_params.npz",
                   f"output_dir={out_dir}/dense_out", "tpu.max_tracks=4"],
                  device="cpu") is not None

# the MOTS20 recipe (`with mots20`, vanilla DETR with masks, softmax
# classes): the tracking CLI over a MOTS20 sequence writing MOTS rows, the
# converter's MOTS mode, and a debug epoch of the training CLI on its JSON
# with a mask head loaded from an .npz and a mask evaluation
mots_data = Path(out_dir) / "mots_data"
chip_smoke.write_mot_sequences(mots_data, ["MOTS20-02"], 3, hw=(54, 96),
                               ext="jpg", mots=True)
mots_over = {"enc_layers": 1, "dec_layers": 1, "hidden_dim": 128,
             "nheads": 8, "dim_feedforward": 64, "num_queries": 8,
             "img_transform.val_width": 64, "img_transform.max_size": 114,
             "tpu.compute_dtype": "float32"}
mots_cfg = load_config("train.yaml", ["mots20"], mots_over)
recipe = FlagshipConfig.from_config(mots_cfg)
mots_model, _ = build_model(recipe, "cpu", torch.Generator().manual_seed(0))
with torch.no_grad():
    mots_model.class_embed.bias[0] = 10.0   # every query a person
save_model_npz(mots_model, out_dir + "/mots/checkpoint.npz", recipe)
dump_config(mots_cfg, out_dir + "/mots/config.yaml")
track_main(["with", "dataset_name=MOTS20-02", f"data_root_dir={mots_data}",
            f"obj_detect_checkpoint_file={out_dir}/mots/checkpoint.npz",
            f"output_dir={out_dir}/mots_out", "tpu.max_tracks=4"],
           device="cpu")
rows = open(out_dir + "/mots_out/MOTS20-02.txt").read().splitlines()
assert rows and all(r.split(" ")[2:5] == ["2", "54", "96"] for r in rows)
convert(["mots20", "--data-root", str(mots_data / "MOTS20")])
state = train_main(
    ["with", "mots20", *(f"{k}={v}" for k, v in mots_over.items()),
     f"mot_path_train={mots_data}/MOTS20", f"mot_path_val={mots_data}/MOTS20",
     "resume=", f"load_mask_head_from_model={out_dir}/mots/checkpoint.npz",
     "tpu.image_buckets=[[128,128]]", "tpu.max_objects=4", "epochs=1",
     "debug=true", "batch_size=1", f"output_dir={out_dir}/mots_run"],
    device="cpu")
assert state.step == 2
# vanilla DETR's attention maps through the tracking CLI (the MOTS model)
track_main(["with", "dataset_name=MOTS20-02", f"data_root_dir={mots_data}",
            f"obj_detect_checkpoint_file={out_dir}/mots/checkpoint.npz",
            f"output_dir={out_dir}/attn_out", "tpu.max_tracks=4",
            "generate_attention_maps=true"], device="cpu")
assert os.path.exists(out_dir + "/attn_out/MOTS20-02.txt")

# COCO panoptic: a two-image panoptic root, `eval_only` with PQ
import json
from PIL import Image
from trackformer_tpu_torch.models.panoptic import id2rgb
pan = Path(out_dir) / "pan"
for sub in ("coco/val2017", "panoptic/panoptic_val2017",
            "panoptic/annotations"):
    (pan / sub).mkdir(parents=True)
pan_anns = []
for i in range(2):
    seg = np.full((48, 64), 100 + i, np.int64)
    seg[10:30, 8:30] = 200 + i
    Image.fromarray(id2rgb(seg)).save(
        pan / f"panoptic/panoptic_val2017/{i}.png")
    Image.fromarray((np.random.RandomState(i).rand(48, 64, 3) * 255)
                    .astype(np.uint8)).save(pan / f"coco/val2017/{i}.jpg")
    pan_anns.append({"image_id": i, "file_name": f"{i}.png", "segments_info": [
        {"id": 100 + i, "category_id": 200, "iscrowd": 0,
         "area": int((seg == 100 + i).sum())},
        {"id": 200 + i, "category_id": 1, "iscrowd": 0, "area": 440}]})
(pan / "panoptic/annotations/panoptic_val2017.json").write_text(json.dumps(
    {"images": [{"id": i, "file_name": f"{i}.jpg", "height": 48,
                 "width": 64} for i in range(2)], "annotations": pan_anns}))
stats = train_main(
    ["with", *(f"{k}={v}" for k, v in mots_over.items()), "masks=true",
     "focal_loss=false", "deformable=false", "dataset=coco_panoptic",
     f"coco_path={pan}/coco", f"coco_panoptic_path={pan}/panoptic",
     "tracking=false", "tracking_eval=false", "eval_only=true",
     "batch_size=2", "tpu.image_buckets=[[128,128]]", "tpu.max_objects=4",
     f"output_dir={out_dir}/pan_run"], device="cpu")
assert "PQ_all" in stats
assert len(os.listdir(out_dir + "/pan_run/panoptic_eval")) == 2

# the tracker's soft reset, and a three-frame step through the previous
# frames with remat
exact_tracker.reset(hard=False)
exact_tracker.step(blob)
assert exact_tracker.frame_index == 5
import dataclasses
three = FlagshipConfig().replace(enc_layers=1, remat=True, **tiny)
model, crit, _, track = build_model(three, "cpu", gen, train=True)
optimizer = make_optimizer(three, model)
step = make_train_step(model, crit, optimizer,
                       dataclasses.replace(track, backprop_prev_frame=True),
                       tracking=True, prev_prev=True)
_, metrics = step(TrainState.create(model, optimizer),
                  {**pack, "prev_prev_batch": blob["batch"],
                   "prev_prev_targets": targets}, gen)
assert bool(torch.isfinite(metrics["loss"]))

# the single-frame family: exact, windowed without the cached memory, and
# shared heads; a Tracker and a detection step each
for named, over in ((["deformable", "tracking"], {}),
                    (["deformable", "tracking", "tpu_fast"],
                     {"with_box_refine": False})):
    single = FlagshipConfig.from_config(load_config("train.yaml", named, {
        "enc_layers": 2, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8, "dropout": 0.0,
        "tpu.compute_dtype": "float32", **over})).replace(max_tracks=4)
    model, post = build_model(single, "cpu", torch.Generator().manual_seed(0))
    tracker = Tracker(model, post, {**single.tracker_cfg, "max_tracks": 4},
                      single.hidden_dim, single.num_queries)
    for _ in range(2):
        tracker.step(blob)
    model, crit, _, track = build_model(single, "cpu", gen, train=True)
    optimizer = make_optimizer(single, model)
    step = make_train_step(model, crit, optimizer, track, tracking=False)
    _, metrics = step(TrainState.create(model, optimizer),
                      {"batch": blob["batch"], "targets": targets}, gen)
    assert bool(torch.isfinite(metrics["loss"]))

# the rest of the family's switches: a two-stage detection step, and a
# Tracker over two frames of each other switch
multi = ["deformable", "tracking", "multi_frame"]
for named, over in ((["deformable", "tracking"], {"two_stage": True}),
                    (multi, {"tpu.decoder_attention": "dense"}),
                    (multi, {"merge_frame_features": True,
                             "num_feature_levels": 5}),
                    (multi, {"tpu.cached_prev_memory": True}),
                    (["deformable", "tracking"], {"backbone": "resnet101",
                                                  "dilation": True}),
                    (multi + ["tpu_fast"], {"tpu.encoder_window": 16})):
    rest = FlagshipConfig.from_config(load_config("train.yaml", named, {
        "enc_layers": 1, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8, "dropout": 0.0,
        "tpu.compute_dtype": "float32", **over})).replace(max_tracks=4)
    if rest.two_stage:
        model, crit, _, track = build_model(rest, "cpu", gen, train=True)
        optimizer = make_optimizer(rest, model)
        step = make_train_step(model, crit, optimizer, track, tracking=False)
        _, metrics = step(TrainState.create(model, optimizer),
                          {"batch": blob["batch"], "targets": targets}, gen)
        assert bool(torch.isfinite(metrics["loss_ce_enc"]))
        continue
    model, post = build_model(rest, "cpu", torch.Generator().manual_seed(0))
    tracker = Tracker(model, post, {**rest.tracker_cfg, "max_tracks": 4},
                      rest.hidden_dim, rest.num_queries)
    for _ in range(2):
        tracker.step(blob)

# the agreement tools, two steps of each arm at the small scale, and a
# window-16 probe
from trackformer_tpu_torch.tools import agree_probe
probe = agree_probe.main(["2", "small", "fast_w16", "--device", "cpu"])
assert probe["fast_w16"]["steps"] == 2
from trackformer_tpu_torch.tools import fast_exact_agreement, tracking_agreement
agree = fast_exact_agreement.main(["2", "small", "--device", "cpu", "--out",
                                   out_dir + "/agree.json"])
assert agree["steps_trained"] == 2 and "exact_map" in agree
tracked = tracking_agreement.main(["2", "small", "--device", "cpu", "--out",
                                   out_dir + "/agree.json"])
assert "fast_idf1" in tracked
assert not any(k.split(".")[0] in ("jax", "jaxlib", "flax")
               for k in sys.modules)
import shutil
shutil.rmtree(out_dir)
print("NO_JAX_OK")
print("OPENED_OUTSIDE=" + repr(opened_outside))
'''


@pytest.fixture(scope="module")
def blocked_run():
    return subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_and_runs_without_jax(blocked_run):
    assert blocked_run.returncode == 0, blocked_run.stderr[-3000:]
    assert "NO_JAX_OK" in blocked_run.stdout


def test_port_reads_no_file_of_the_jax_side(blocked_run):
    assert blocked_run.returncode == 0, blocked_run.stderr[-3000:]
    assert "OPENED_OUTSIDE=[]" in blocked_run.stdout, blocked_run.stdout


def test_no_jax_import_lines_in_port_sources():
    """No line of the port or of the card's scripts (chip_smoke.py,
    chip_profile.py, chip_trained_offsets.py, chip_resume_drift.py) imports JAX,
    flax or any module of the JAX package (`trackformer_tpu`, not the
    port's own `trackformer_tpu_torch`)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                         r"trackformer_tpu)(?![\w])", re.M)
    files = sorted((REPO / "trackformer_tpu_torch").rglob("*.py"))
    files += [REPO / name for name in ("chip_smoke.py", "chip_profile.py",
                                       "chip_trained_offsets.py",
                                       "chip_resume_drift.py")]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
