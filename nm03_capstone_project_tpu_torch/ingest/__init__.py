"""Streaming ingest: decode pool -> staging ring -> stager -> the card.

:mod:`.pipeline` and :mod:`.ring` are torch-free at import; torch enters
through the stage callable, :mod:`.staging`.
"""

from nm03_capstone_project_tpu_torch.ingest.pipeline import (  # noqa: F401
    DEFAULT_DEPTH,
    DEFAULT_STAGED_DEPTH,
    IngestFailure,
    IngestPipeline,
)
from nm03_capstone_project_tpu_torch.ingest.ring import (  # noqa: F401
    RingClosed,
    RingFinished,
    StagingRing,
)
