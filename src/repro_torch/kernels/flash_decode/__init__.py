from repro_torch.kernels.flash_decode.flash_decode import flash_decode_gqa
from repro_torch.kernels.flash_decode.flash_decode_mla import block_s as mla_block_s
from repro_torch.kernels.flash_decode.flash_decode_mla import flash_decode_mla
from repro_torch.kernels.flash_decode.ref import (gqa_decode_ref,
                                                  gqa_decode_splitk,
                                                  mla_decode_ref,
                                                  mla_decode_splitk)

__all__ = ["flash_decode_gqa", "flash_decode_mla", "gqa_decode_ref",
           "gqa_decode_splitk", "mla_block_s", "mla_decode_ref",
           "mla_decode_splitk"]
