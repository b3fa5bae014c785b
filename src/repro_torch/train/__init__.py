from repro_torch.train.optimizer import adam_update, init_opt_state, lr_at
from repro_torch.train.train_loop import (AUX_WEIGHT, accumulate_grads,
                                          build_train_step, make_train_state,
                                          resolve_microbatches)

__all__ = ["AUX_WEIGHT", "accumulate_grads", "adam_update",
           "build_train_step", "init_opt_state", "lr_at", "make_train_state",
           "resolve_microbatches"]
