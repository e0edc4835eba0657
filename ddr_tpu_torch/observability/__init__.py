"""Run observability of the port: the numerical-health stats and watchdog,
the recovery supervisor that acts on them, and (in their own modules) the
run recorder (``events``), its phase timer, throughput counter and spans."""

from ddr_tpu_torch.observability.health import (
    HealthConfig,
    HealthStats,
    HealthWatchdog,
    ReachStats,
)
from ddr_tpu_torch.observability.recovery import (
    RECOVERY_STAGES,
    REROUTE_REASONS,
    RecoveryConfig,
    RecoveryGiveUp,
    RecoverySupervisor,
)

__all__ = [
    "RECOVERY_STAGES",
    "REROUTE_REASONS",
    "HealthConfig",
    "HealthStats",
    "HealthWatchdog",
    "ReachStats",
    "RecoveryConfig",
    "RecoveryGiveUp",
    "RecoverySupervisor",
]
