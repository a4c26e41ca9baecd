"""Training plane: optimizer, train step, checkpointing, trainer loop
(counterpart of ``repro.train``)."""

from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_step import TrainState, make_train_step

__all__ = ["AdamWConfig", "TrainState", "adamw_init", "adamw_update",
           "make_train_step"]
