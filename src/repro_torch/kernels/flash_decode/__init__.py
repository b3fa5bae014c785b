from repro_torch.kernels.flash_decode.flash_decode import flash_decode_gqa
from repro_torch.kernels.flash_decode.ref import (gqa_decode_ref,
                                                  gqa_decode_splitk)

__all__ = ["flash_decode_gqa", "gqa_decode_ref", "gqa_decode_splitk"]
