"""Online tracking (counterpart of trackformer_tpu.tracking)."""
from .tracker import Tracker, TrackerConfig  # noqa: F401
