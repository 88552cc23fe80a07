from videovanish_tpu_torch.train.train_step import (
    TrainState, make_train_step, restore_train_state, save_train_state,
)

__all__ = ["TrainState", "make_train_step", "restore_train_state",
           "save_train_state"]
