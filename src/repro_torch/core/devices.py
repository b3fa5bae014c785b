"""Accelerator catalog: the heterogeneous device types MARP/HAS plan over.

The JAX package's catalog (``repro.core.devices``), entry for entry, plus
``H100-80G``, the card the port runs on.  The paper's cluster uses NVIDIA
GPUs; the TPU entries are the reference's hardware adaptation.  ``flops``
is peak dense bf16/fp16 tensor throughput; ``hbm_bw`` bytes/s; ``link_bw``
bytes/s per chip of intra-node interconnect (NVLink / ICI).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class DeviceType:
    name: str
    mem: int                 # bytes of HBM
    flops: float             # peak bf16 FLOP/s
    hbm_bw: float            # bytes/s
    link_bw: float           # bytes/s per chip intra-node (NVLink/ICI)
    inter_bw: float          # bytes/s per chip cross-node (PCIe+IB / DCN)
    #: mean time between crash-faults of ONE device, seconds.  The failure
    #: plane derives everything from this: a node's hazard is
    #: devices-per-node / mtbf_s, an n-device plan's aggregate MTBF is
    #: mtbf_s / n (independent exponentials), and the Young–Daly default
    #: checkpoint interval is sqrt(2 * C * MTBF_agg).  Datacenter parts
    #: sit around a month, consumer cards lower, TPU pods higher.
    mtbf_s: float = 30.0 * 86400.0


GB = 1024 ** 3
TF = 1e12
DAY = 86400.0

DEVICE_TYPES: Dict[str, DeviceType] = {
    # --- paper's GPU catalog ---
    "A100-40G":  DeviceType("A100-40G",  40 * GB, 312 * TF, 1.55e12, 600e9, 64e9, 30 * DAY),
    "A100-80G":  DeviceType("A100-80G",  80 * GB, 312 * TF, 2.0e12,  600e9, 64e9, 30 * DAY),
    "A800-80G":  DeviceType("A800-80G",  80 * GB, 312 * TF, 2.0e12,  400e9, 64e9, 30 * DAY),
    "RTX2080Ti": DeviceType("RTX2080Ti", 11 * GB, 26.9 * TF, 616e9,  32e9,  16e9, 10 * DAY),
    "RTX6000":   DeviceType("RTX6000",   24 * GB, 130 * TF, 672e9,   32e9,  16e9, 15 * DAY),
    "RTX3090":   DeviceType("RTX3090",   24 * GB, 71 * TF,  936e9,   32e9,  16e9, 10 * DAY),
    # --- TPU adaptation (the JAX package's target hardware) ---
    "v5e":       DeviceType("v5e",       16 * GB, 197 * TF, 819e9,   50e9,  25e9, 45 * DAY),
    "v4":        DeviceType("v4",        32 * GB, 275 * TF, 1.2e12,  50e9,  25e9, 45 * DAY),
    "v5p":       DeviceType("v5p",       95 * GB, 459 * TF, 2.76e12, 100e9, 25e9, 45 * DAY),
    # --- the port's card: H100 SXM5 (NVIDIA's data sheet: 989 TFLOP/s dense
    # bf16, 3.35 TB/s, NVLink 900 GB/s); inter_bw and mtbf_s are A100-80G's,
    # the catalog's other datacenter part, for want of a published figure ---
    "H100-80G":  DeviceType("H100-80G",  80 * GB, 989 * TF, 3.35e12, 900e9, 64e9, 30 * DAY),
}

# Roofline constants for the JAX package's production mesh (v5e pod).
TPU_PEAK_FLOPS = 197e12       # bf16 per chip
TPU_HBM_BW = 819e9            # bytes/s
TPU_ICI_BW = 50e9             # bytes/s per link
