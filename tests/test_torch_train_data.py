"""The port's training data path against the JAX package's, on the CPU,
through numpy: the training transforms (one draw of each from the same
`numpy.random.default_rng` seed), the mask RLE codec, the COCO / MOT
datasets' samples with their previous frames (the same `np.random.seed`),
`collate_fn`'s packs, the weighted concatenation's sample weights, the
`Loader`'s packs over an epoch with weighted sampling and prefetch, the
MOT detection result files and the MOT -> COCO converter's JSON. All of
them are equal bit for bit. Then the two places where the port differs:
its `Loader` raises an error of the dataset where the JAX one ends the
epoch early without one, and its MOT dataset reads the images where the
converter links them."""
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from trackformer_tpu.cli.train import Loader as JLoader
from trackformer_tpu.datasets import builder as jbuilder
from trackformer_tpu.datasets import mot as jmot
from trackformer_tpu.datasets import transforms as JT
from trackformer_tpu.utils import rle as jrle
from trackformer_tpu_torch.cli.train import Loader
from trackformer_tpu_torch.datasets import builder, mot
from trackformer_tpu_torch.datasets import transforms as T
from trackformer_tpu_torch.tools.generate_coco_from_mot import \
    generate_coco_from_mot
from trackformer_tpu_torch.utils import rle
from trackformer_tpu_torch.utils.config import load_config, nested_namespace

sys.path.insert(0, str(Path(__file__).parent))
from synth_data import make_synth_mot  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BUCKETS = [(96, 128), (128, 160)]
MAX_OBJECTS = 3


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(h=100, w=160, seed=0, uint8=False):
    rs = np.random.RandomState(seed)
    img = rs.rand(h, w, 3).astype(np.float32)
    if uint8:
        img = (img * 255).astype(np.uint8)
    boxes = np.array([[20.0, 30.0, 60.0, 90.0], [-5.0, 10.0, 40.0, 50.0],
                      [120.0, 60.0, 170.0, 99.0], [70.0, 5.0, 90.0, 25.0]],
                     np.float32)
    target = {
        "boxes": boxes,
        "labels": np.array([0, 0, 1, 0]),
        "area": np.array([2400.0, 1800.0, 1950.0, 400.0], np.float32),
        "iscrowd": np.array([0, 0, 0, 1]),
        "track_ids": np.array([7, 8, 9, 10]),
        "ignore": np.array([False, True, False, False]),
        "size": np.array([h, w]),
        "orig_size": np.array([h, w]),
        "image_id": np.int64(3),
    }
    return img, target


def assert_same(got, want, where=""):
    """Equal as arrays, bit for bit, key by key for dicts."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, where
    assert np.array_equal(got, want, equal_nan=True), where


def transform_pairs():
    """(name, port transform, JAX transform), applied to (img, target, rng)."""
    img_transform = SimpleNamespace(max_size=200, val_width=96)
    pairs = [
        ("crop", lambda i, t, r: T.crop(i, t, (10, 20, 60, 90)),
         lambda i, t, r: JT.crop(i, t, (10, 20, 60, 90))),
        ("crop_overflow", lambda i, t, r: T.crop(i, t, (10, 20, 60, 90),
                                                 True),
         lambda i, t, r: JT.crop(i, t, (10, 20, 60, 90), True)),
        ("hflip", lambda i, t, r: T.hflip(i, t),
         lambda i, t, r: JT.hflip(i, t)),
        ("resize", lambda i, t, r: T.resize(i, t, 80, 120),
         lambda i, t, r: JT.resize(i, t, 80, 120)),
        ("resize_to_hw", lambda i, t, r: T.resize(i, t, (70, 50)),
         lambda i, t, r: JT.resize(i, t, (70, 50))),
    ]
    for name, args in (("RandomHorizontalFlip", (0.5,)),
                       ("RandomResize", ([64, 80, 96], 150)),
                       ("FixedResize", (90, 140)),
                       ("RandomSizeCrop", (40, 90)),
                       ("CenterCrop", ((50, 70),)),
                       ("RandomPad", (12,)),
                       ("RandomErasing", (0.9,)),
                       ("Normalize", ())):
        pairs.append((name, getattr(T, name)(*args),
                      getattr(JT, name)(*args)))
    pairs += [
        ("RandomSizeCrop_overflow", T.RandomSizeCrop(40, 90, True),
         JT.RandomSizeCrop(40, 90, True)),
        ("RandomSelect", T.RandomSelect(T.RandomResize([60, 70]),
                                        T.RandomPad(9)),
         JT.RandomSelect(JT.RandomResize([60, 70]), JT.RandomPad(9))),
        ("Compose", T.Compose([T.RandomHorizontalFlip(), T.RandomPad(5)]),
         JT.Compose([JT.RandomHorizontalFlip(), JT.RandomPad(5)])),
        ("make_coco_transforms_train",
         T.make_coco_transforms("train", img_transform, True),
         JT.make_coco_transforms("train", img_transform, True)),
        ("make_coco_transforms_train_no_crop",
         T.make_coco_transforms("train", img_transform, no_crop=True),
         JT.make_coco_transforms("train", img_transform, no_crop=True)),
        ("make_coco_transforms_val",
         T.make_coco_transforms("val", img_transform),
         JT.make_coco_transforms("val", img_transform)),
    ]
    return pairs


PAIRS = transform_pairs()


@pytest.mark.parametrize("name,port,jax_side", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_training_transform_matches_jax(name, port, jax_side):
    for seed in range(6):
        for uint8 in (False, True):
            img, target = sample(seed=seed, uint8=uint8)
            got = port(img.copy(), dict(target), np.random.default_rng(seed))
            want = jax_side(img.copy(), dict(target),
                            np.random.default_rng(seed))
            assert_same(got[0], want[0], f"{name} seed {seed} image")
            assert_same(got[1], want[1], f"{name} seed {seed} target")


def test_transforms_refuse_masks():
    img, target = sample()
    target["masks"] = np.ones((4, 100, 160), bool)
    for fn in (lambda: T.hflip(img, target),
               lambda: T.crop(img, target, (0, 0, 10, 10)),
               lambda: T.resize(img, target, 50)):
        with pytest.raises(NotImplementedError, match="item 6"):
            fn()


def test_rle_matches_jax():
    rs = np.random.RandomState(4)
    masks = [rs.rand(23, 31) > 0.6, np.zeros((5, 7), bool),
             np.ones((6, 4), bool), rs.rand(40, 3) > 0.1]
    for mask in masks:
        enc = rle.encode_mask(mask)
        assert enc == jrle.encode_mask(mask)
        assert np.array_equal(rle.decode_mask(enc), mask)
        counts = rle.mask_to_rle_counts(mask)
        assert counts == jrle.mask_to_rle_counts(mask)
        assert rle.decode_rle_string(enc["counts"]) == counts
        assert rle.mask_area(enc) == int(mask.sum()) == jrle.mask_area(enc)
    for counts in ([0, 5, 3, 1000, 2, 70000], [12], [3, 1, 1, 1]):
        s = rle.encode_rle_string(counts)
        assert s == jrle.encode_rle_string(counts)
        assert rle.decode_rle_string(s.encode()) == counts
    poly = [[2.0, 3.0, 20.0, 4.0, 15.0, 18.0], [25.0, 25.0, 28.0, 26.0]]
    assert np.array_equal(rle.segmentation_to_mask(poly, 30, 32),
                          jrle.segmentation_to_mask(poly, 30, 32))
    a, b = rle.encode_mask(masks[0]), rle.encode_mask(masks[0] & (
        rs.rand(23, 31) > 0.5))
    assert rle.rle_iou(a, b) == jrle.rle_iou(a, b)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return make_synth_mot(tmp_path_factory.mktemp("trainmot"), n_seqs=2,
                          n_frames=6)


def train_args(root, **over):
    overrides = {"dataset": "mot", "mot_path_train": str(root),
                 "mot_path_val": str(root), "train_split": "synth_train",
                 "val_split": "synth_train", "track_prev_frame_range": 2,
                 "img_transform.max_size": 160,
                 "img_transform.val_width": 96, **over}
    return nested_namespace(load_config(
        "train.yaml", ["deformable", "tracking", "multi_frame"], overrides))


def numpy_pack(pack):
    """A pack of either package -> {frame: {field: numpy}}."""
    out = {}
    for name, v in pack.items():
        fields = {k: getattr(v, k) for k in ("images", "mask", "labels",
                                             "boxes", "valid", "track_ids",
                                             "orig_size", "size", "image_id",
                                             "area", "iscrowd")
                  if getattr(v, k, None) is not None}
        out[name] = {k: (x.numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x)) for k, x in fields.items()}
    return out


@pytest.mark.parametrize("image_set", ["train", "val"])
def test_mot_samples_match_jax(synth_root, image_set):
    """Items with their previous frame (a real frame within the range,
    the same augmentation, its own jitter), from the same global seed."""
    args = train_args(synth_root)
    port_ds = mot.build_mot(image_set, args)
    jax_ds = jmot.build_mot(image_set, args)
    assert port_ds.ids == jax_ds.ids
    order = [0, 5, 11, 6, 3]
    np.random.seed(5)
    got = [port_ds[i] for i in order]
    np.random.seed(5)
    want = [jax_ds[i] for i in order]
    for g, w in zip(got, want):
        assert set(g) == {"image", "target", "prev_image", "prev_target"}
        assert_same(g, w, image_set)
    # a frame of the same sequence within the range (6 frames a sequence)
    reach = 2 if image_set == "train" else 1
    for g in got:
        cur, prev = int(g["target"]["image_id"]), int(
            g["prev_target"]["image_id"])
        assert abs(cur - prev) <= reach and cur // 6 == prev // 6


def test_coco_detection_sample_matches_jax(synth_root):
    """The synthetic previous frame of a COCO-style dataset: the same
    image, the jitter crop."""
    from trackformer_tpu.datasets import coco as jcoco
    from trackformer_tpu_torch.datasets import coco

    ann = synth_root / "annotations" / "synth_train.json"
    kw = dict(prev_frame=True, prev_frame_rnd_augs=0.2, overflow_boxes=True,
              min_num_objects=1)
    port_ds = coco.CocoDetection(synth_root / "train", ann,
                                 T.make_coco_transforms("train"),
                                 T.Normalize(), **kw)
    jax_ds = jcoco.CocoDetection(synth_root / "train", ann,
                                 JT.make_coco_transforms("train"),
                                 JT.Normalize(), **kw)
    np.random.seed(2)
    got = [port_ds[i] for i in (1, 7)]
    np.random.seed(2)
    want = [jax_ds[i] for i in (1, 7)]
    for g, w in zip(got, want):
        assert_same(g, w)
    assert np.array_equal(port_ds.sample_weights, jax_ds.sample_weights)
    with pytest.raises(NotImplementedError, match="item 6"):
        coco.CocoDetection(synth_root / "train", ann, None, T.Normalize(),
                           return_masks=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        coco.CocoDetection(synth_root / "train", ann, None, T.Normalize(),
                           prev_prev_frame=True)


def test_collate_and_weights_match_jax(synth_root):
    args = train_args(synth_root)
    port_ds, jax_ds = mot.build_mot("train", args), jmot.build_mot(
        "train", args)
    np.random.seed(9)
    samples = [port_ds[i] for i in (2, 9, 4)]
    np.random.seed(9)
    jsamples = [jax_ds[i] for i in (2, 9, 4)]
    for batch in (samples[:1], samples[:2], samples):
        jbatch = jsamples[:len(batch)]
        got = builder.collate_fn(batch, BUCKETS, MAX_OBJECTS)
        want = jbuilder.collate_fn(jbatch, BUCKETS, MAX_OBJECTS)
        assert set(got) == {"batch", "targets", "prev_batch",
                            "prev_targets"}
        assert_same(numpy_pack(got), numpy_pack(want))
    assert builder.pick_bucket([(90, 100), (60, 128)], BUCKETS) == (96, 128)
    assert builder.pick_bucket([(97, 100)], BUCKETS) == (128, 160)
    with pytest.raises(ValueError, match="largest bucket"):
        builder.pad_image(np.zeros((130, 10, 3)), (128, 160))
    cat = mot.WeightedConcatDataset([port_ds, port_ds])
    jcat = jmot.WeightedConcatDataset([jax_ds, jax_ds])
    assert len(cat) == 2 * len(port_ds)
    assert np.array_equal(cat.sample_weights, jcat.sample_weights)
    assert cat.sample_weights.sum() == pytest.approx(2.0)
    assert builder.get_coco_api_from_dataset(cat) is port_ds
    packed = builder.pack_to(got, "cpu")
    assert packed["batch"].images.device.type == "cpu"


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_packs_match_jax(synth_root, prefetch):
    """Weighted sampling from seed + epoch over two epochs, with and
    without the prefetch thread: the same packs as the JAX Loader's for
    the same np.random.seed."""
    args = train_args(synth_root)
    port_ds, jax_ds = mot.build_mot("train", args), jmot.build_mot(
        "train", args)

    def run(loader_cls, ds, collate):
        np.random.seed(11)
        loader = loader_cls(ds, 2, collate, shuffle=True,
                            weights=ds.sample_weights, seed=4,
                            prefetch=prefetch)
        return [numpy_pack(p) for _ in range(2) for p in loader], len(loader)

    got, n = run(Loader, port_ds, lambda s: builder.collate_fn(
        s, BUCKETS, MAX_OBJECTS))
    want, jn = run(JLoader, jax_ds, lambda s: jbuilder.collate_fn(
        s, BUCKETS, MAX_OBJECTS))
    assert n == jn == 6 and len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert_same(g, w)
    ordered = Loader(port_ds, 4, lambda s: [x["target"]["image_id"]
                                            for x in s], shuffle=False,
                     drop_last=False, prefetch=prefetch)
    assert [int(i) for b in ordered for i in b] == list(range(12))


class Planted:
    """A dataset whose item `bad` raises."""

    def __init__(self, n, bad):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"cannot read item {i}")
        return i


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_raises_a_dataset_error(prefetch):
    """The port's Loader raises the dataset's error in the consumer; the
    JAX Loader's prefetch thread ends the epoch early without it."""
    loader = Loader(Planted(10, 5), 2, list, shuffle=False,
                    prefetch=prefetch)
    seen = []
    with pytest.raises(OSError, match="item 5"):
        for batch in loader:
            seen.append(batch)
    assert seen == [[0, 1], [2, 3]]
    jax_batches = list(JLoader(Planted(10, 5), 2, list, shuffle=False))
    assert jax_batches == [[0, 1], [2, 3]]


def test_loader_thread_stops_with_the_consumer():
    import threading
    loader = Loader(Planted(40, -1), 2, list, shuffle=False, prefetch=2)
    before = threading.active_count()
    it = iter(loader)
    assert next(it) == [0, 1]
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before


def test_write_result_files_matches_jax(synth_root, tmp_path):
    args = train_args(synth_root)
    port_ds, jax_ds = mot.build_mot("val", args), jmot.build_mot(
        "val", args)
    rs = np.random.RandomState(0)
    results = {i: {"boxes": rs.rand(5, 4) * 50 + [0, 0, 60, 60],
                   "scores": rs.rand(5)} for i in port_ds.ids[::2]}
    got = port_ds.write_result_files(results, str(tmp_path / "port"))
    want = jax_ds.write_result_files(results, str(tmp_path / "jax"))
    assert [Path(p).name for p in got] == [Path(p).name for p in want] == [
        "SYN-01.txt", "SYN-02.txt"]
    for g, w in zip(got, want):
        assert Path(g).read_text() == Path(w).read_text()
        assert Path(g).read_text()


@pytest.mark.parametrize("frame_range", [None, {"start": 0.5, "end": 1.0}])
def test_converter_matches_jax(tmp_path, frame_range):
    root = make_synth_mot(tmp_path / "MOT17", n_seqs=2, n_frames=4)
    gt = root / "train" / "SYN-02" / "gt" / "gt.txt"
    lines = gt.read_text().splitlines()
    lines[-1] = lines[-1].rsplit(",", 1)[0] + ",0.2"  # mostly occluded
    gt.write_text("\n".join(lines) + "\n")
    jtool = load_jax_tool("generate_coco_from_mot")
    ann = root / "annotations" / "conv.json"
    jtool.generate_coco_from_mot("conv", str(root), frame_range=frame_range)
    want = json.loads(ann.read_text())
    generate_coco_from_mot("conv", str(root), frame_range=frame_range)
    got = json.loads(ann.read_text())
    assert got == want
    assert any(a["ignore"] for a in got["annotations"])
    links = sorted(p.name for p in (root / "conv").iterdir())
    assert links == sorted(im["file_name"] for im in got["images"])
    with pytest.raises(NotImplementedError, match="item 6"):
        generate_coco_from_mot("conv", str(root), mots=True)


def test_mot_reads_the_converted_split(tmp_path):
    """The converter links `<seq>_<frame>.jpg` into `<root>/<split>/`; the
    port's MOT dataset reads them there (the JAX one reads `<root>/train/`,
    where that name does not exist)."""
    from trackformer_tpu_torch.datasets.image_io import read_frame

    root = make_synth_mot(tmp_path / "MOT17", n_seqs=1, n_frames=3)
    generate_coco_from_mot("conv", str(root))
    ds = mot.build_mot("val", train_args(root, val_split="conv",
                                         **{"img_transform.val_width": 128}))
    frame = read_frame(root / "train" / "SYN-01" / "img1" / "000002.jpg")
    np.random.seed(0)
    item = ds[1]
    want = (frame.astype(np.float32) / 255.0 - T.IMAGENET_MEAN) \
        / T.IMAGENET_STD
    assert item["image"].shape == frame.shape
    np.testing.assert_allclose(item["image"], want, atol=1e-5)
    assert len(item["target"]["boxes"]) == 2
    with pytest.raises(FileNotFoundError):
        jmot.build_mot("val", train_args(root, val_split="conv"))[1]


def test_an_upright_crop_fits_no_bucket():
    """Seed 275 of the training pipeline takes a 1080x1920 frame to an
    upright crop taller than every image bucket (ROADMAP Queue 3, open):
    in both packages `pick_bucket` falls back to the largest bucket and
    `pad_image` raises; the port's `Loader` raises it (the test above)."""
    frame = np.zeros((1080, 1920, 3), np.uint8)
    target = {"boxes": np.zeros((0, 4), np.float32)}
    got, _ = T.make_coco_transforms("train", overflow_boxes=True)(
        frame, dict(target), np.random.default_rng(275))
    want, _ = JT.make_coco_transforms("train", overflow_boxes=True)(
        frame, dict(target), np.random.default_rng(275))
    assert got.shape == want.shape and got.shape[0] > 1088 > got.shape[1]
    buckets = [(608, 1088), (800, 1344), (1088, 1920)]
    assert builder.pick_bucket([got.shape[:2]], buckets) == (1088, 1920)
    for pad in (builder.pad_image, jbuilder.pad_image):
        with pytest.raises(ValueError, match="largest bucket"):
            pad(got, (1088, 1920))


def upright_crop_share(draws: int):
    """{bucket or "none": share of `draws` seeded samples of the training
    pipeline on a 1080x1920 frame} and the seeds that fit no bucket. Only
    the sizes matter, so Pillow's resize returns a blank image of the
    asked size."""
    from unittest import mock

    from PIL import Image

    pipeline = T.make_coco_transforms("train", overflow_boxes=True)
    buckets = [(608, 1088), (800, 1344), (1088, 1920)]
    frame = np.zeros((1080, 1920, 3), np.uint8)
    counts, misfits = {}, []
    with mock.patch.object(Image.Image, "resize",
                           lambda im, size, *a: Image.new(im.mode, size)):
        for seed in range(draws):
            target = {"boxes": np.zeros((0, 4), np.float32)}
            img, _ = pipeline(frame, target, np.random.default_rng(seed))
            h, w = img.shape[:2]
            bucket = builder.pick_bucket([(h, w)], buckets)
            fits = h <= bucket[0] and w <= bucket[1]
            key = "x".join(map(str, bucket)) if fits else "none"
            counts[key] = counts.get(key, 0) + 1
            if not fits:
                misfits.append(seed)
    return {k: v / draws for k, v in sorted(counts.items())}, misfits


if __name__ == "__main__":
    # the share of training samples of a 1080x1920 frame in each image
    # bucket, and the seeds whose upright crop fits none (ROADMAP Queue 3)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4000
    shares, seeds = upright_crop_share(n)
    print(f"{n} draws: {shares}; no bucket at seeds {seeds}")
