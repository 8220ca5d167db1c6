"""Training substrate: optimizers, train step, checkpointing, data."""
from repro_torch.training.optimizer import (adafactor, adamw, cosine_schedule,
                                            global_norm, make_optimizer)
from repro_torch.training.train_state import TrainState

__all__ = ["adafactor", "adamw", "cosine_schedule", "global_norm",
           "make_optimizer", "TrainState"]
