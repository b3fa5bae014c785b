from repro_torch.train.optimizer import adam_update, init_opt_state, lr_at
from repro_torch.train.train_loop import (AUX_WEIGHT, accumulate_grads,
                                          build_train_step, make_local_state,
                                          make_train_state, n_data_shards,
                                          resolve_microbatches, state_specs)

__all__ = ["AUX_WEIGHT", "accumulate_grads", "adam_update",
           "build_train_step", "init_opt_state", "lr_at", "make_local_state",
           "make_train_state", "n_data_shards", "resolve_microbatches",
           "state_specs"]
