"""Resilience: the per-patient slice journal and supervised dispatch.

* :mod:`.journal` — :class:`PatientJournal`, slice-grain crash-safe resume
  (the batch drivers);
* :mod:`.policy` — :class:`RetryPolicy`, :class:`Deadline` and
  :class:`ResilienceConfig`;
* :mod:`.supervisor` — :class:`DispatchSupervisor`, the deadline-guarded
  dispatch each serving lane runs under.

The JAX package's fault plans are not ported yet, and its CPU degradation
is not ported at all.
"""

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
