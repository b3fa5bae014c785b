"""Hand-written Hopper kernels and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the calls in which its wrapper launched
the kernel on the card; a run reads it to show that its path went through
the kernels.  The wrappers import ``LAUNCHES`` from here, so it is defined
before any submodule is imported.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0,
                            "flash_decode_gqa": 0, "flash_decode_mla": 0,
                            "adam_update": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
