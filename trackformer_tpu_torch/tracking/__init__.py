"""Online tracking (counterpart of trackformer_tpu.tracking)."""
from .batched import BatchedTracker, group_by_shape  # noqa: F401
from .tracker import Tracker, TrackerConfig  # noqa: F401
