"""Registry of tracking datasets, with the JAX package's names
(`trackformer_tpu/datasets/tracking/factory.py`)."""
from __future__ import annotations

from typing import Union

from .demo_sequence import DemoSequence
from .mot_wrapper import MOT17Wrapper, MOT20Wrapper, MOTS20Wrapper

DATASETS = {}

for split in ["TRAIN", "TEST", "ALL", "01", "02", "03", "04", "05", "06",
              "07", "08", "09", "10", "11", "12", "13", "14"]:
    for dets in ["DPM", "FRCNN", "SDP", "ALL"]:
        DATASETS[f"MOT17-{split}-{dets}"] = (
            lambda kw, s=split, d=dets: MOT17Wrapper(s, d, **kw))

for split in ["TRAIN", "TEST", "ALL", "01", "02", "03", "04", "05", "06",
              "07", "08"]:
    DATASETS[f"MOT20-{split}"] = (
        lambda kw, s=split: MOT20Wrapper(s, **kw))

for split in ["TRAIN", "TEST", "ALL", "01", "02", "05", "06", "07", "09",
              "11", "12"]:
    DATASETS[f"MOTS20-{split}"] = (
        lambda kw, s=split: MOTS20Wrapper(s, **kw))

DATASETS["DEMO"] = (lambda kw: [DemoSequence(**kw)])


class TrackDatasetFactory:
    """Concatenation of named tracking datasets."""

    def __init__(self, datasets: Union[str, list], **kwargs):
        if isinstance(datasets, str):
            datasets = [datasets]
        self._data = []
        for name in datasets:
            if name not in DATASETS:
                raise KeyError(f"[!] Dataset not found: {name}")
            self._data.extend(list(DATASETS[name](kwargs)))

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]
