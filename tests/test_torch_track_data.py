"""The port's serving data path held against the JAX package on the CPU:
the YAML configs and the command line, the eval-time preprocessing, the
frame reader and the MOTChallenge sequences.

Tolerances: configs, parsed files and result files are equal exactly. The
preprocessing of the port (the native library's bilinear, kept in float32)
is bit-equal to the JAX package's native route, and within one uint8 level
over the smallest std (1 / 255 / 0.224 = 0.01751) of its PIL route, which
rounds the resized frame to uint8.
"""
import io
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from trackformer_tpu import native as jnative
from trackformer_tpu.datasets.tracking import DATASETS as JDATASETS
from trackformer_tpu.datasets.tracking import \
    TrackDatasetFactory as JFactory
from trackformer_tpu.datasets.tracking import mot17_sequence as jmot
from trackformer_tpu.datasets.tracking.demo_sequence import \
    DemoSequence as JDemo
from trackformer_tpu.utils import config as jconfig
from trackformer_tpu_torch import native
from trackformer_tpu_torch.datasets import transforms as T
from trackformer_tpu_torch.datasets.image_io import read_frame
from trackformer_tpu_torch.datasets.tracking import DATASETS, \
    TrackDatasetFactory
from trackformer_tpu_torch.datasets.tracking import mot17_sequence as tmot
from trackformer_tpu_torch.datasets.tracking.demo_sequence import DemoSequence
from trackformer_tpu_torch.utils import config as tconfig
from trackformer_tpu_torch.utils.config import FlagshipConfig

sys.path.insert(0, str(Path(__file__).parent))
from synth_data import make_synth_mot  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NAMED = ["deformable", "tracking", "multi_frame"]
# one uint8 level over the smallest std, and the float32 rounding of the
# two normalized outputs (|x| < 2.7)
PIL_ROUTE_TOL = 1 / 255 / 0.224 + 1e-6


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

# the line of each of two files whose comment named a local path of the
# original TrackFormer's configs
RENAMED_COMMENT = {"track.yaml": 0, "train.yaml": 1}


def test_configs_are_copies_of_the_jax_ones():
    """Byte for byte, but for that comment line."""
    jax_dir = REPO / "trackformer_tpu" / "cfgs"
    names = sorted(p.name for p in jax_dir.glob("*.yaml"))
    assert len(names) == 16
    assert sorted(p.name for p in tconfig.CFG_DIR.glob("*.yaml")) == names
    for name in names:
        got = (tconfig.CFG_DIR / name).read_bytes()
        want = (jax_dir / name).read_bytes()
        if name in RENAMED_COMMENT:
            i = RENAMED_COMMENT[name]
            got, want = got.split(b"\n"), want.split(b"\n")
            assert got[i].startswith(b"#") and want[i].startswith(b"#")
            assert got[i] != want[i], name
            got[i] = want[i]
        assert got == want, name


LOADS = [
    ("train.yaml", NAMED, {}),
    ("train.yaml", NAMED + ["tpu_fast"], {}),
    ("track.yaml", [], {}),
    ("track.yaml", ["reid"], {}),
    ("train.yaml", NAMED, {"lr": 3e-5, "tpu.image_buckets": [[64, 96]],
                           "img_transform.val_width": 128}),
    ("train.yaml", ["mots20"], {}),
    ("train.yaml", ["coco_person_masks"], {}),
]


@pytest.mark.parametrize("base,named,overrides", LOADS,
                         ids=["train", "train_fast", "track", "track_reid",
                              "overrides", "mots20", "coco_person_masks"])
def test_load_config_matches_jax(base, named, overrides):
    want = jconfig.load_config(base, named, overrides)
    assert tconfig.load_config(base, named, overrides) == want


def test_parse_cli_matches_jax():
    argv = ["tracker_cfg.detection_obj_score_thresh=0.5",
            "frame_range.end=0.25", "lr=1e-4", "write_images=pretty",
            "dataset_name=[MOT17-02-FRCNN,MOT17-04-FRCNN]",
            "load_results_dir=null", "tpu.batch_sequences=2",
            "interpolate=true", "seed=7"]
    for base, named in (("track.yaml", "reid"), ("train.yaml", "tpu_fast")):
        want = jconfig.parse_cli(["with", named, *argv], base=base)
        got = tconfig.parse_cli(["with", named, *argv], base=base)
        assert got == want
    assert got["lr"] == 1e-4 and got["tpu"]["batch_sequences"] == 2
    with pytest.raises(FileNotFoundError):
        tconfig.parse_cli(["with", "no_such_config"], base="track.yaml")


def test_from_config_gives_the_flagship():
    exact = tconfig.load_config("train.yaml", NAMED)
    fast = tconfig.load_config("train.yaml", NAMED + ["tpu_fast"])
    # train.yaml's `tpu.remat: true`, which the dataclass leaves off
    assert FlagshipConfig.from_config(exact) == FlagshipConfig().replace(
        remat=True)
    assert FlagshipConfig.from_config(fast) == FlagshipConfig.tpu_fast(
        remat=True)
    cfg = FlagshipConfig.from_config(tconfig.load_config(
        "train.yaml", NAMED, {"hidden_dim": 96, "tpu.compute_dtype":
                              "float32", "img_transform.max_size": 170,
                              "img_transform.val_width": 128}))
    assert (cfg.hidden_dim, cfg.compute_dtype, cfg.max_size,
            cfg.val_width) == (96, "float32", 170, 128)
    # plain train.yaml builds vanilla DETR (with learned positions too,
    # whose flag neither package's models read); what is not ported is
    # refused by the factory, naming its item
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.models.detr import DETR
    vanilla = FlagshipConfig.from_config(tconfig.load_config(
        "train.yaml", [], {"enc_layers": 1, "dec_layers": 1,
                           "tpu.compute_dtype": "float32"}))
    assert not vanilla.deformable and not vanilla.focal_loss
    assert type(build_model(vanilla, "cpu")[0]) is DETR
    assert type(build_model(vanilla.replace(position_embedding="learned"),
                            "cpu")[0]) is DETR
    # COCO panoptic: the 250-class mask model (251 softmax logits)
    from trackformer_tpu_torch.models.segmentation import DETRSegm
    panoptic = build_model(vanilla.replace(dataset="coco_panoptic",
                                           masks=True), "cpu")[0]
    assert type(panoptic) is DETRSegm
    assert panoptic.class_embed.out_features == 251


def test_dump_config_round_trips(tmp_path):
    cfg = tconfig.load_config("train.yaml", NAMED + ["tpu_fast"],
                              {"lr": 2e-5, "tracker_cfg": {"a": None}})
    tconfig.dump_config(cfg, tmp_path / "sub" / "config.yaml")
    text = (tmp_path / "sub" / "config.yaml").read_text()
    assert yaml.safe_load(text) == cfg
    buf = io.StringIO()
    yaml.safe_dump(cfg, buf, sort_keys=False)
    assert text == buf.getvalue()
    ns = tconfig.nested_namespace(cfg)
    assert ns.tpu.encoder_attention == "windowed"
    assert tconfig.namespace_to_dict(ns) == cfg


# --------------------------------------------------------------------------
# preprocessing
# --------------------------------------------------------------------------

@pytest.fixture
def jax_pil_route(monkeypatch):
    """The JAX package's preprocessing as it stands without its native
    library: the PIL route."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.fixture
def jax_native_route(monkeypatch):
    """The JAX package's native route, on the library the port built (a
    test-time assignment; the JAX package's files are not touched)."""
    monkeypatch.setattr(jnative, "_LIB", native.load())
    monkeypatch.setattr(jnative, "_TRIED", True)


FRAME_SIZES = [(1080, 1920), (480, 640), (128, 160)]


def random_frame(hw, seed):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3),
                                               dtype=np.uint8)


@pytest.mark.parametrize("hw", FRAME_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("route", ["pil", "native"])
def test_preprocess_frame_matches_jax(hw, route, request):
    request.getfixturevalue(f"jax_{route}_route")
    img = random_frame(hw, hw[0])
    resize = T.FixedResize(800, max_size=1333)
    got, got_hw = tmot.preprocess_frame(img, resize)
    want, want_hw = jmot.preprocess_frame(img, jmot.T.FixedResize(
        800, max_size=1333))
    assert got_hw == tuple(want_hw)
    assert got.shape == want.shape and got.dtype == np.float32
    h, w = got_hw
    if route == "native":
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= PIL_ROUTE_TOL
        assert not got[h:].any() and not got[:, w:].any()
        assert np.array_equal(got[h:], want[h:])
        assert np.array_equal(got[:, w:], want[:, w:])
    if hw == (1080, 1920):
        assert got.shape[:2] == (768, 1344) and got_hw == (750, 1333)


def test_eval_transforms_match_jax():
    from trackformer_tpu.datasets import transforms as JT
    img = random_frame((90, 120), 3)
    target = {"boxes": np.array([[10, 20, 50, 60]], np.float32),
              "size": np.array([90, 120])}
    for size, max_size in ((64, None), (64, 80), (90, 1333)):
        assert T.get_size_with_aspect_ratio((90, 120), size, max_size) == \
            JT.get_size_with_aspect_ratio((90, 120), size, max_size)
        got, gt = T.FixedResize(size, max_size)(img, dict(target))
        want, wt = JT.FixedResize(size, max_size)(img.astype(np.float32)
                                                  / 255.0, dict(target))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1 / 255 + 1e-6
        np.testing.assert_allclose(gt["boxes"], wt["boxes"], rtol=1e-6)
        assert np.array_equal(gt["size"], wt["size"])
        gn, gtn = T.Normalize()(got, gt)
        wn, wtn = JT.Normalize()(got, wt)
        assert np.array_equal(gn, wn)
        np.testing.assert_allclose(gtn["boxes"], wtn["boxes"], rtol=1e-6)


def test_native_library_builds_outside_the_jax_side():
    so = native.build()
    assert so.parent == REPO / "trackformer_tpu_torch" / "_build"
    assert not (REPO / "native" / so.name).exists()
    mask = np.zeros((7, 9), bool)
    mask[2:5, 3:8] = True
    counts = native.rle_encode(mask)
    assert np.array_equal(native.rle_decode(counts, 7, 9), mask)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

def png_filters(data: bytes) -> set:
    import struct
    import zlib
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(raw[:, 0].tolist())


def average_friendly(rng, h, w, ch):
    """Each pixel near the mean of its left and upper neighbours: Pillow's
    optimizing encoder picks the Average filter for such rows."""
    a = rng.randint(0, 256, (h, w, ch)).astype(np.int64)
    for i in range(1, h):
        for j in range(1, w):
            a[i, j] = ((a[i - 1, j] + a[i, j - 1]) // 2 + a[i, j] % 5) % 256
    return a.astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_read_frame_matches_pillow_on_png(mode, tmp_path):
    ch = len(mode)
    rng = np.random.RandomState(ch)
    h, w = 24, 40
    images = [rng.randint(0, 256, (h, w, ch), dtype=np.uint8),
              (np.cumsum(rng.randint(0, 3, (h, w, ch)), 1) % 256
               ).astype(np.uint8),
              average_friendly(rng, h, w, ch)]
    seen = set()
    for k, a in enumerate(images):
        path = tmp_path / f"{k}.png"
        Image.fromarray(a[..., 0] if ch == 1 else a, mode).save(
            path, optimize=k == 2)
        seen |= png_filters(path.read_bytes())
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        got = read_frame(path)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        assert np.array_equal(got, want)
        # gray repeated, alpha dropped
        rgb = np.repeat(a[..., :1], 3, 2) if ch <= 2 else a[..., :3]
        assert np.array_equal(got, rgb)
    assert seen == {0, 1, 2, 3, 4}


def test_read_frame_other_formats_need_pillow(tmp_path, monkeypatch):
    a = random_frame((16, 24), 5)
    Image.fromarray(a).save(tmp_path / "f.jpg")
    Image.fromarray(a).convert("P").save(tmp_path / "p.png")
    Image.fromarray(a).save(tmp_path / "rgb.png")
    for name in ("f.jpg", "p.png"):
        with Image.open(tmp_path / name) as im:
            assert np.array_equal(read_frame(tmp_path / name),
                                  np.asarray(im.convert("RGB")))
    assert np.array_equal(read_frame(tmp_path / "rgb.png"), a)
    # without Pillow every frame raises, naming it
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name in ("f.jpg", "rgb.png"):
        with pytest.raises(RuntimeError, match="needs Pillow"):
            read_frame(tmp_path / name)


# --------------------------------------------------------------------------
# sequences
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mot_root(tmp_path_factory):
    """A synthetic MOT17-layout sequence named MOT17-02-FRCNN, with public
    detections."""
    root = tmp_path_factory.mktemp("synthmot") / "MOT17"
    make_synth_mot(root, n_seqs=1, n_frames=4)
    dst = root / "train" / "MOT17-02-FRCNN"
    (root / "train" / "SYN-01").rename(dst)
    (dst / "det").mkdir()
    rng = np.random.RandomState(0)
    rows = [f"{f},-1,{x:.2f},{y:.2f},{w:.2f},{h:.2f},{c:.3f}"
            for f in range(1, 5) for x, y, w, h, c in rng.uniform(
                1, 60, (3, 5)) / [1, 1, 1, 1, 60]]
    (dst / "det" / "det.txt").write_text("\n".join(rows) + "\n")
    return root.parent


def test_sequence_matches_jax(mot_root, tmp_path, jax_native_route):
    img_transform = SimpleNamespace(val_width=128, max_size=170)
    jseq = JFactory("MOT17-02-FRCNN", root_dir=str(mot_root),
                    img_transform=img_transform)[0]
    tseq = TrackDatasetFactory("MOT17-02-FRCNN", root_dir=str(mot_root),
                               img_transform=img_transform)[0]
    assert str(tseq) == str(jseq) and len(tseq) == len(jseq) == 4
    assert tseq.no_gt == jseq.no_gt is False
    for i in range(len(jseq)):
        jb, tb = jseq[i], tseq[i]
        for key in ("gt", "vis"):
            assert jb[key].keys() == tb[key].keys()
            for k in jb[key]:
                assert np.array_equal(jb[key][k], tb[key][k])
        assert len(tb["dets"]) == 3
        for key in ("dets", "orig_size", "size"):
            assert np.array_equal(tb[key], jb[key]), key
        assert tb["img_path"] == jb["img_path"]
        assert isinstance(tb["batch"].images, torch.Tensor)
        assert np.array_equal(tb["batch"].images.numpy(),
                              np.asarray(jb["batch"].images))
        assert np.array_equal(tb["batch"].mask.numpy(),
                              np.asarray(jb["batch"].mask))
    rng = np.random.RandomState(1)
    results = {tid: {f: {"bbox": rng.uniform(0, 100, 4).astype(np.float32),
                         "score": 0.9} for f in range(0, 4, tid + 1)}
               for tid in range(3)}
    jseq.write_results(results, str(tmp_path / "jax"))
    tseq.write_results(results, str(tmp_path / "port"))
    name = "MOT17-02-FRCNN.txt"
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()
    assert tseq.load_results(str(tmp_path / "port")) == \
        jseq.load_results(str(tmp_path / "port"))
    assert tseq.load_results(None) == {} == tseq.load_results(
        str(tmp_path / "none"))


def test_demo_folder_matches_jax(mot_root, jax_native_route):
    folder = mot_root / "MOT17" / "train" / "MOT17-02-FRCNN" / "img1"
    jseq, tseq = JDemo(str(folder)), DemoSequence(str(folder))
    assert str(tseq) == str(jseq) and len(tseq) == len(jseq)
    assert tseq.no_gt
    for i in range(len(jseq)):
        jb, tb = jseq[i], tseq[i]
        for key in ("orig_size", "size", "dets"):
            assert np.array_equal(tb[key], jb[key]), key
        assert np.array_equal(tb["batch"].images.numpy(),
                              np.asarray(jb["batch"].images))


def test_dataset_names_match_jax(tmp_path):
    assert sorted(DATASETS) == sorted(JDATASETS)
    # MOTS20-TRAIN reads a synthetic layout as the JAX factory does
    from test_torch_mots import make_mots_layout
    root = make_mots_layout(tmp_path, names=["MOTS20-02", "MOTS20-05",
                                             "MOTS20-09", "MOTS20-11"],
                            n_frames=2)
    tseqs = TrackDatasetFactory("MOTS20-TRAIN", root_dir=str(root))
    jseqs = JFactory("MOTS20-TRAIN", root_dir=str(root))
    assert [str(q) for q in tseqs] == [str(q) for q in jseqs] == [
        "MOTS20-02", "MOTS20-05", "MOTS20-09", "MOTS20-11"]
    for tq, jq in zip(tseqs, jseqs):
        assert len(tq) == len(jq) == 2 and not tq.no_gt
        for i in range(2):
            assert tq.data[i]["gt"].keys() == jq.data[i]["gt"].keys()
    with pytest.raises(KeyError, match="not found"):
        TrackDatasetFactory("MOT99-TRAIN", root_dir="data")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        TrackDatasetFactory("MOT17-02-FRCNN", root_dir="no_such_dir")
