from repro_torch.kernels.adam_update.adam_update import adam_update
from repro_torch.kernels.adam_update.ref import adam_ref

__all__ = ["adam_update", "adam_ref"]
