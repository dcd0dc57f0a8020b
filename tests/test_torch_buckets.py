"""The train CLI's image buckets hold every frame the training transforms
make (ROADMAP Queue 3): `tpu.image_buckets` of `train.yaml` tops out at
1088x1920, but an upright crop taken to a long side of
`img_transform.max_size` (1333) is taller than 1088. The CLI adds a square
bucket of `max_size` rounded up to 64 (1344x1344), says so, and uses it
for the batches no configured bucket holds (`builder.bucket_for`): seed
275's upright frame lands there and pads, while every batch a configured
bucket holds keeps its bucket. The samples are untouched: only the
padding of such a batch differs from the JAX pipeline, which raises on
it.
"""
import numpy as np
import torch

from trackformer_tpu_torch.cli.train import image_buckets
from trackformer_tpu_torch.datasets import builder
from trackformer_tpu_torch.datasets import transforms as T
from trackformer_tpu_torch.utils.config import load_config

CONFIGURED = [(608, 1088), (800, 1344), (1088, 1920)]


def test_cli_buckets_hold_the_upright_crop(capsys):
    cfg = load_config("train.yaml")
    buckets, fallback = image_buckets(cfg["tpu"], cfg["img_transform"])
    assert buckets == CONFIGURED and fallback == (1344, 1344)
    assert "added 1344x1344" in capsys.readouterr().out
    frame = np.zeros((1080, 1920, 3), np.uint8)
    img, _ = T.make_coco_transforms("train", overflow_boxes=True)(
        frame, {"boxes": np.zeros((0, 4), np.float32)},
        np.random.default_rng(275))
    h, w = img.shape[:2]
    assert h > 1088 > w                      # the crop stands upright
    assert builder.bucket_for([(h, w)], buckets) == (1088, 1920)
    assert builder.bucket_for([(h, w)], buckets, fallback) == (1344, 1344)
    target = {"labels": np.zeros(0, np.int64), "boxes": np.zeros((0, 4)),
              "track_ids": np.zeros(0, np.int64), "orig_size": [1080, 1920],
              "size": [h, w], "image_id": 0}
    pack = builder.collate_fn(
        [{"image": img.astype(np.float32), "target": target}], buckets, 4,
        fallback=fallback)
    assert tuple(pack["batch"].images.shape[1:3]) == (1344, 1344)
    assert torch.equal(pack["batch"].images[0, :h, :w],
                       torch.from_numpy(img.astype(np.float32)))
    assert bool(pack["batch"].mask[0, h:].all())


def test_cli_buckets_keep_every_batch_a_bucket_holds(capsys):
    """A frame a configured bucket holds keeps that bucket with the
    fallback present (the square would be the smaller for 1000x1300); where
    a configured bucket holds a `max_size` square, nothing is added."""
    _, fallback = image_buckets({}, {"max_size": 1333})
    for hw, want in (((600, 1000), (608, 1088)), ((800, 1333), (800, 1344)),
                     ((1000, 1300), (1088, 1920))):
        assert builder.bucket_for([hw], CONFIGURED, fallback) == want
    assert image_buckets({"image_buckets": [[800, 1344], [1344, 1344]]},
                         {"max_size": 1333}) == ([(800, 1344), (1344, 1344)],
                                                 None)
    assert image_buckets({"image_buckets": [[608, 1088]]},
                         {"max_size": 1000}) == ([(608, 1088)], (1024, 1024))
    assert capsys.readouterr().out.count("added") == 2
