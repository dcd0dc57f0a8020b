"""Model modules of the port (counterparts of trackformer_tpu.models)."""
from .factory import build_model  # noqa: F401
