"""The control plane's leaves: the device catalog, the analytic memory
model (MARP's prediction), the memory feedback plane and the MFU / decode
calibration, each the JAX package's module of the same name.  MARP, HAS,
the lifecycle engine and the serverless API, which the JAX package's
``repro.core`` also holds, are not ported yet."""
from repro_torch.core import calibration, devices, memory_model, memtrace  # noqa: F401
