"""Training on one card: AdamW, the train step and loop, checkpoints."""

from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .loop import TrainConfig, make_train_step, train  # noqa: F401
