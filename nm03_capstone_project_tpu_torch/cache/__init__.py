"""Content-addressed result tier (the server's ``--result-cache-bytes``).

The port's copy of the JAX package's ``cache/`` for single-slice serving:
a segmentation result keyed on the sha256 of the input bytes, the
algorithm, its parameters and the program version
(:mod:`~nm03_capstone_project_tpu_torch.cache.keys`), held in a bounded,
verify-on-read store (:mod:`~nm03_capstone_project_tpu_torch.cache.store`).
The in-flight index that coalesces volume retries comes with volume
serving, in a later slice. Stdlib only.
"""

from nm03_capstone_project_tpu_torch.cache.keys import (
    ResultKey,
    digest_bytes,
    params_digest,
    result_key,
    result_version,
)
from nm03_capstone_project_tpu_torch.cache.store import (
    ResultEntry,
    ResultStore,
    content_etag,
    etag_matches,
    parse_bytes,
)

__all__ = [
    "ResultEntry",
    "ResultKey",
    "ResultStore",
    "content_etag",
    "digest_bytes",
    "etag_matches",
    "params_digest",
    "parse_bytes",
    "result_key",
    "result_version",
]
