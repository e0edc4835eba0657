"""Run observability of the port: the numerical-health stats and watchdog,
the recovery supervisor that acts on them, the forcing validator, fault
injection and the preemption handler, and (in their own modules) the run
recorder (``events``), its phase timer, throughput counter and spans."""

from ddr_tpu_torch.observability.faults import (
    FAULT_SITES,
    FaultPlan,
    InjectedFault,
    fault_site,
    maybe_inject,
    parse_faults,
)
from ddr_tpu_torch.observability.health import (
    HealthConfig,
    HealthStats,
    HealthWatchdog,
    ReachStats,
)
from ddr_tpu_torch.observability.preempt import PreemptionHandler
from ddr_tpu_torch.observability.recovery import (
    RECOVERY_STAGES,
    REROUTE_REASONS,
    ForcingValidator,
    RecoveryConfig,
    RecoveryGiveUp,
    RecoverySupervisor,
)

__all__ = [
    "FAULT_SITES",
    "RECOVERY_STAGES",
    "REROUTE_REASONS",
    "FaultPlan",
    "ForcingValidator",
    "HealthConfig",
    "HealthStats",
    "HealthWatchdog",
    "InjectedFault",
    "PreemptionHandler",
    "ReachStats",
    "RecoveryConfig",
    "RecoveryGiveUp",
    "RecoverySupervisor",
    "fault_site",
    "maybe_inject",
    "parse_faults",
]
