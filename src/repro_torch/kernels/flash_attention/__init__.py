from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_lse)
from repro_torch.kernels.flash_attention.ops import flash_attention_trainable
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_lse",
           "flash_attention_trainable", "attention_ref", "attention_lse_ref",
           "attention_bwd_ref"]
