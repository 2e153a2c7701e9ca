from repro_torch.train.optimizer import AdamW, cosine_schedule, global_norm
from repro_torch.train.train_step import (TrainState, TrainStepConfig,
                                          init_state, make_train_step)

__all__ = ["AdamW", "cosine_schedule", "global_norm", "TrainState",
           "TrainStepConfig", "init_state", "make_train_step"]
