"""Hand-written Hopper kernels and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the calls in which its wrapper launched
the kernel on the card; a run reads it to show that its path went through
the kernels.  The wrappers import ``LAUNCHES`` from here, so it is defined
before any submodule is imported.
"""
from typing import Dict, Iterable

import torch

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0,
                            "flash_decode_gqa": 0, "flash_decode_mla": 0,
                            "adam_update": 0, "ssd_scan": 0,
                            "ssd_scan_bwd": 0, "rms_norm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def refuse_grad(kernel: str, tensors: Iterable[torch.Tensor],
                missing: str) -> None:
    """Raise NotImplementedError when grad is enabled and an input requires
    grad: ``kernel`` has no backward (``missing`` names it), and a result
    cut from the autograd graph would train on a wrong gradient without a
    word.  Called before the device check, so it holds on the CPU too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward: {missing} is not written yet, so it "
            f"refuses inputs that require grad (run it under "
            f"torch.no_grad(), or differentiate the plain version on the CPU)")
