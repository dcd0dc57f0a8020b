from .factory import DATASETS, TrackDatasetFactory  # noqa: F401
