"""The kernels on the ``meta`` device: the card's path, run where nothing
runs.

A meta tensor carries a shape and a dtype and no storage.  Dispatch sends
it to the kernel's own wrapper, which checks it and allocates exactly what
it allocates on the card (the outputs, the split-KV partials, the SSD
scratch) and stops before the launch: no ``nvcc`` build, no library call,
no ``LAUNCHES`` count.  So a step traced on meta holds, at each moment,
the tensors the card's step holds (``launch.op_analysis`` follows them for
the dry run's peak), where the plain versions would hold the full
(b, H, s, s) scores or Adam's temporaries instead.

The kernels' launch plans (the GQA decode's split, the MLA decode's split
and merge, the SSD scan's segments) are computed here, for the card and
for meta alike, and passed into the launches: where a plan reads the SM
count, a CUDA tensor gives its card's and a meta tensor the H100's,
``SM_COUNT``.

Each stand-in reports its work to the tally open at the time
(``launch.op_analysis``): its FLOPs by formula -- the count
``torch.utils.flop_counter.FlopCounterMode`` gives the op's plain version
at the same shapes, the product the JAX package's dry run counts on the
plain path -- and the bytes of its operands and outputs, each once.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

#: SMs of the NVIDIA H100 SXM5 (80GB HBM3), the card the dry run stands for
SM_COUNT = 132
#: rows per tile of ``csrc/flash_decode.cu`` and its most tiles a split
GQA_TILE, GQA_MAX_TILES = 64, 8
#: ``csrc/flash_decode_mla.cu``: splits, their least and most rows, the
#: most splits merged in one cluster
MLA_SPLITS, MLA_SPLIT_MIN, MLA_SPLIT_MAX, MLA_MAX_CLUSTER = 6, 64, 1024, 8
MLA_HEADS_BF16, MLA_HEADS_F32 = 64, 16
#: rows per chunk of ``csrc/ssd_scan.cu`` and ``csrc/ssd_scan_bwd.cu``
SSD_CHUNK = SSD_BWD_CHUNK = 64
#: the chunk of the plain SSD scan (``dispatch.ssd``'s default), whose
#: FLOPs the SSD stand-ins count
SSD_REF_CHUNK = 128

#: the open tally, called (op, flops, bytes) by every stand-in; None: closed
TALLY: Optional[Callable[[str, float, int], None]] = None


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def record(op: str, flops: float, inputs: Sequence[torch.Tensor],
           outputs: Sequence[torch.Tensor]) -> None:
    """One stand-in call: its FLOPs and the bytes of its operands and
    outputs, to the open tally."""
    if TALLY is not None:
        TALLY(op, float(flops), sum(t.numel() * t.element_size()
                                    for t in (*inputs, *outputs)
                                    if t is not None))


# ------------------------------------------------- the kernels' launch plans --

@functools.cache
def _card_sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """SMs of the card ``t`` lies on; on meta, the H100's."""
    if is_meta(t):
        return SM_COUNT
    index = t.device.index
    return _card_sm_count(torch.cuda.current_device() if index is None
                          else index)


def gqa_block_s(b: int, S: int, K: int, sm_count: int = SM_COUNT) -> int:
    """Cache rows a split of ``csrc/flash_decode.cu``: 64 times the tiles
    that still leave ~4 blocks an SM, at most 8 tiles."""
    tiles = -(-S // GQA_TILE)
    per = tiles * b * K // (4 * max(sm_count, 1))
    return GQA_TILE * min(max(per, 1), GQA_MAX_TILES)


def mla_plan(b: int, S: int, H: int, bf16: bool, bs: int = 0) -> tuple:
    """The launch of ``csrc/flash_decode_mla.cu``: (rows a split, grid
    (splits, head tiles, b), whether the splits merge in one cluster).
    Unless ``bs`` > 0 names one, the split is from the cache length alone,
    so a row's output does not depend on the batch around it: at most 6
    splits of at least 64 rows and at most 1024, a multiple of 16."""
    if bs <= 0:
        r16 = lambda n: -(-n // 16) * 16   # noqa: E731
        rows = min(max(r16(-(-S // MLA_SPLITS)), MLA_SPLIT_MIN),
                   MLA_SPLIT_MAX)
        bs = min(rows, r16(S))
    ns = -(-S // bs)
    heads = MLA_HEADS_BF16 if bf16 else MLA_HEADS_F32
    return bs, (ns, -(-H // heads), b), bf16 and ns <= MLA_MAX_CLUSTER


def ssd_segment_chunks(b: int, s: int, h: int,
                       sm_count: int = SM_COUNT) -> int:
    """Chunks a segment of ``csrc/ssd_scan.cu``'s bfloat16 scan: as many
    segments as give ~2 blocks of its chunk scan an SM, no more than the
    chunks."""
    nc = -(-s // SSD_CHUNK)
    bh = b * h
    nseg = min(max(-(-2 * max(sm_count, 1) // bh), 1), nc)
    return -(-nc // nseg)


# ----------------------------------------- FLOPs of the plain versions --

def attention_flops(b: int, sq: int, sk: int, H: int, D: int) -> int:
    """``attention_ref``: the full (sq, sk) scores and their product with
    V, masked or not (2 + 2 FLOPs a pair a head dim)."""
    return 4 * b * H * sq * sk * D


def attention_bwd_flops(b: int, sq: int, sk: int, H: int, D: int) -> int:
    """Autograd of ``attention_ref`` (q, k, v all requiring grad): both
    products' two operand gradients."""
    return 2 * attention_flops(b, sq, sk, H, D)


def gqa_decode_flops(b: int, S: int, H: int, D: int) -> int:
    """``gqa_decode_ref``: q . K over the S slots, then P . V."""
    return 4 * b * H * S * D


def mla_decode_flops(b: int, S: int, H: int, r: int, dr: int) -> int:
    """``mla_decode_ref``: the latent and rope scores, then P . c_kv."""
    return 2 * b * H * S * (2 * r + dr)


def ssd_flops(b: int, s: int, h: int, p: int, n: int,
              chunk: int = SSD_REF_CHUNK) -> int:
    """``ssd_chunked`` at ``chunk``: C.B^T in each chunk, the diagonal
    blocks' y, the chunk states and the off-diagonal y."""
    L = min(chunk, s)
    nc = -(-s // L)
    return 2 * b * nc * L * (L * n + L * h * p + 2 * h * p * n)


def ssd_bwd_flops(b: int, s: int, h: int, p: int, n: int,
                  chunk: int = SSD_REF_CHUNK) -> int:
    """Autograd of ``ssd_scan_ref`` with every input requiring grad: each
    product's two operand gradients, less the first chunk's off-diagonal
    y, whose state (zeros) needs none."""
    L = min(chunk, s)
    return 2 * ssd_flops(b, s, h, p, n, chunk) - 2 * b * L * h * p * n

