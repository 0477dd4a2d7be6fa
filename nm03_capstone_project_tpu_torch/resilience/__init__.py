"""Crash-safe resume: the per-patient slice journal.

Only :mod:`.journal` is ported; the retry policies, the dispatch supervisor
and the fault plans of the JAX package's ``resilience/`` are not.
"""

from nm03_capstone_project_tpu_torch.resilience.journal import PatientJournal  # noqa: F401
