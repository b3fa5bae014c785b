"""The port's entry points: ``serve`` and ``train``."""
from __future__ import annotations

import os

# Growable segments in place of fixed ones for PyTorch's caching allocator:
# jamba's 32k-token prefill holds 48 GiB of weights and 4 GB (E, C, f) MoE
# tensors and does not fit the card when freed blocks stay split in fixed
# segments.
ALLOC_CONF = "expandable_segments:True"


def configure_allocator() -> None:
    """Set ``PYTORCH_CUDA_ALLOC_CONF`` to ``ALLOC_CONF`` unless the caller
    set it.  The allocator reads it when it first reserves device memory,
    so call this before anything touches the card."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
