"""Sequence-list wrappers: a split name -> its sequences."""
from __future__ import annotations

from .mot17_sequence import MOT17Sequence
from .mot20_sequence import MOT20Sequence
from .mots20_sequence import MOTS20Sequence

MOT17_TRAIN = ["02", "04", "05", "09", "10", "11", "13"]
MOT17_TEST = ["01", "03", "06", "07", "08", "12", "14"]
MOT20_TRAIN = ["01", "02", "03", "05"]
MOT20_TEST = ["04", "06", "07", "08"]
MOTS20_TRAIN = ["02", "05", "09", "11"]
MOTS20_TEST = ["01", "06", "07", "12"]


def _expand(split: str, train: list, test: list) -> list:
    if split == "TRAIN":
        return train
    if split == "TEST":
        return test
    if split == "ALL":
        return sorted(train + test)
    if split in train + test:
        return [split]
    raise NotImplementedError(f"MOT split not available: {split}")


class _Wrapper:
    def __init__(self, sequences):
        self._data = sequences

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class MOT17Wrapper(_Wrapper):
    def __init__(self, split: str, dets: str, **kwargs):
        names = _expand(split, MOT17_TRAIN, MOT17_TEST)
        dets_list = ["DPM", "FRCNN", "SDP"] if dets == "ALL" else [dets]
        seqs = [MOT17Sequence(seq_name=f"MOT17-{n}", dets=d, **kwargs)
                for n in names for d in dets_list]
        super().__init__(seqs)


class MOT20Wrapper(_Wrapper):
    def __init__(self, split: str, **kwargs):
        names = _expand(split, MOT20_TRAIN, MOT20_TEST)
        super().__init__([MOT20Sequence(seq_name=f"MOT20-{n}", **kwargs)
                          for n in names])


class MOTS20Wrapper(_Wrapper):
    def __init__(self, split: str, **kwargs):
        names = _expand(split, MOTS20_TRAIN, MOTS20_TEST)
        super().__init__([MOTS20Sequence(seq_name=f"MOTS20-{n}", **kwargs)
                          for n in names])
