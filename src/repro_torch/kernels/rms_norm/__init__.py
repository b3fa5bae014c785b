from repro_torch.kernels.rms_norm.ops import rms_norm_trainable
from repro_torch.kernels.rms_norm.ref import rms_norm_bwd_ref, rms_norm_ref
from repro_torch.kernels.rms_norm.rms_norm import rms_norm

__all__ = ["rms_norm", "rms_norm_bwd_ref", "rms_norm_ref", "rms_norm_trainable"]
