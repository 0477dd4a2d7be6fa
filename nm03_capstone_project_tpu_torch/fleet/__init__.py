"""Replica-level fault domains: the fleet front end.

The port's copy of the JAX package's ``fleet/``: where the server makes
the lane the fault domain inside one process, this package makes the
replica process the fault domain — capacity-weighted routing from the
replicas' own published signals, outlier ejection through a HEALTHY →
EJECTED → PROBATION → HEALTHY machine, bounded-hop failover for in-flight
riders, backpressure (Retry-After) propagation, and a rolling restart that
never drops below (N−1)/N capacity. The replicas are the port's servers
(``python -m nm03_capstone_project_tpu_torch.serving.server``), each with
its own CUDA context and graphs, all on one card or on several.

Free of torch and numpy at import: the router is stdlib orchestration and
must never load a backend or claim the card.
"""

from nm03_capstone_project_tpu_torch.fleet.manager import (
    RestartError,
    rolling_restart,
)
from nm03_capstone_project_tpu_torch.fleet.replicas import (
    EJECTED,
    HEALTHY,
    PROBATION,
    REPLICA_STATE_VALUES,
    ReplicaStates,
    normalize_target,
    target_label,
)
from nm03_capstone_project_tpu_torch.fleet.router import (
    FleetApp,
    make_http_server,
    serve_in_thread,
)

__all__ = [
    "EJECTED",
    "HEALTHY",
    "PROBATION",
    "REPLICA_STATE_VALUES",
    "FleetApp",
    "ReplicaStates",
    "RestartError",
    "make_http_server",
    "normalize_target",
    "rolling_restart",
    "serve_in_thread",
    "target_label",
]
