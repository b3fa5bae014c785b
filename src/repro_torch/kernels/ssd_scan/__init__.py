from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_naive, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

__all__ = ["ssd_chunked", "ssd_naive", "ssd_scan", "ssd_scan_ref"]
