"""MOT20 sequence: the MOT17 layout in another folder."""
from .mot17_sequence import MOTSequenceBase


class MOT20Sequence(MOTSequenceBase):
    data_folder = "MOT20"
