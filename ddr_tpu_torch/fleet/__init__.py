"""The fleet tier of the port: everything above one
:class:`~ddr_tpu_torch.serving.service.ForecastService`, as the JAX package's
``ddr_tpu/fleet``:

- :mod:`.group` — :class:`ReplicaGroup`: N replicas (in-process services or
  ``serve`` subprocesses) behind one router, published to the federation
  plane;
- :mod:`.router` — :class:`Router`: least-queue-depth dispatch with
  health-aware ejection and background re-probe;
- :mod:`.ensemble` — :class:`EnsembleRunner`: E-member ensemble forecasts in
  one batched route, on the JAX package's threefry draws (:mod:`.prng`);
- :mod:`.canary` — :class:`CanaryController`: skill-gated promotion between
  two registered models.
"""

from ddr_tpu_torch.fleet.canary import STATES, CanaryController
from ddr_tpu_torch.fleet.config import FLEET_MODES, FleetConfig, fleet_identity
from ddr_tpu_torch.fleet.ensemble import (
    DEFAULT_PERCENTILES,
    EnsembleRunner,
    member_forcing,
    perturbation_seed,
)
from ddr_tpu_torch.fleet.group import ReplicaGroup
from ddr_tpu_torch.fleet.router import (
    HttpReplica,
    InProcessReplica,
    NoHealthyReplicaError,
    Router,
)

__all__ = [
    "CanaryController",
    "DEFAULT_PERCENTILES",
    "EnsembleRunner",
    "FLEET_MODES",
    "FleetConfig",
    "HttpReplica",
    "InProcessReplica",
    "NoHealthyReplicaError",
    "ReplicaGroup",
    "Router",
    "STATES",
    "fleet_identity",
    "member_forcing",
    "perturbation_seed",
]
