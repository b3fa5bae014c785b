from repro_torch.kernels.rms_norm.ops import (gated_rms_norm_trainable,
                                              rms_norm_trainable)
from repro_torch.kernels.rms_norm.ref import (gated_rms_norm_bwd_ref,
                                              gated_rms_norm_ref,
                                              rms_norm_bwd_ref, rms_norm_ref)
from repro_torch.kernels.rms_norm.rms_norm import rms_norm, rms_norm_bwd

__all__ = ["gated_rms_norm_bwd_ref", "gated_rms_norm_ref",
           "gated_rms_norm_trainable", "rms_norm", "rms_norm_bwd",
           "rms_norm_bwd_ref", "rms_norm_ref", "rms_norm_trainable"]
