"""Run observability of the port: the numerical-health stats and watchdog,
and the recovery supervisor that acts on them."""

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
