"""Training engine of the port (counterpart of trackformer_tpu.engine)."""
from .train_step import (TrainState, label_params,  # noqa: F401
                         make_optimizer, make_train_step)
