"""The control plane: the device catalog, the analytic memory model, the
memory feedback plane and the MFU / decode calibration (the leaves),
and MARP, HAS, the lifecycle engine, the orchestrator and the serverless
API on top of them, each the JAX package's module of the same name."""
from repro_torch.core import calibration, devices, memory_model, memtrace  # noqa: F401
from repro_torch.core.marp import ResourcePlan, predict_plans, required_devices  # noqa: F401
from repro_torch.core.has import Node, Allocation, schedule, select_plan, place  # noqa: F401
from repro_torch.core.lifecycle import Job, LifecycleEngine, ClusterEvent  # noqa: F401
from repro_torch.core.orchestrator import Orchestrator, make_cluster  # noqa: F401
from repro_torch.core.serverless import submit, SubmitResult  # noqa: F401
