from repro_torch.cluster.simulator import (  # noqa: F401
    ClusterEvent, Job, LifecycleEngine, SimJob, SimResult, simulate,
)
from repro_torch.cluster.schedulers import (  # noqa: F401
    ElasticFlowScheduler, FrenzyScheduler, OpportunisticScheduler,
    SiaScheduler,
)
from repro_torch.cluster.traces import churn_schedule, spot_schedule  # noqa: F401
