"""Resilience: the per-patient slice journal and supervised dispatch.

* :mod:`.journal` — :class:`PatientJournal`, slice-grain crash-safe resume
  (the batch drivers);
* :mod:`.policy` — :class:`RetryPolicy`, :class:`Deadline` and
  :class:`ResilienceConfig`;
* :mod:`.supervisor` — :class:`DispatchSupervisor`, the deadline-guarded
  dispatch each serving lane and the batch drivers run under;
* :mod:`.faultinject` — :class:`FaultPlan`, the seeded chaos plans the
  drivers and the server consult at their injection points.

The JAX package's CPU degradation is not ported: a dispatch whose retries
are exhausted or whose deadline expires fails, it is never recomputed on
the CPU.
"""

from nm03_capstone_project_tpu_torch.resilience.faultinject import (  # noqa: F401
    FaultAbandoned,
    FaultPlan,
    FaultRule,
    InjectedDecodeError,
    InjectedExportError,
    InjectedTransientError,
    corrupt_bytes,
    deliver_sigterm,
    execute_hang,
)
from nm03_capstone_project_tpu_torch.resilience.journal import PatientJournal  # noqa: F401
from nm03_capstone_project_tpu_torch.resilience.policy import (  # noqa: F401
    Deadline,
    DeadlineExceeded,
    ResilienceConfig,
    RetryPolicy,
    TransientDeviceError,
    is_retryable,
)
from nm03_capstone_project_tpu_torch.resilience.supervisor import (  # noqa: F401
    DispatchSupervisor,
)
