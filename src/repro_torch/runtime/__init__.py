"""Host-side fault tolerance — the port of `repro.runtime`; imports
neither torch nor anything of the port that does."""
from repro_torch.runtime.ft import (  # noqa: F401
    HeartbeatMonitor, StragglerMitigator, retry, ElasticPlan, plan_remesh,
)
