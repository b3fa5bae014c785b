from repro_torch.kernels.ssd_scan.ops import ssd_scan_trainable
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked, ssd_naive,
                                              ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd

__all__ = ["ssd_chunked", "ssd_naive", "ssd_scan", "ssd_scan_bwd",
           "ssd_scan_bwd_ref", "ssd_scan_ref", "ssd_scan_trainable"]
