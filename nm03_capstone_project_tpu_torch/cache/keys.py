"""Content-addressed result keys.

The port's copy of the JAX package's ``cache/keys.py``. A result is
addressed by *everything that could change it*:

    (input-bytes digest, algo, params digest, program version)

The program version (:func:`result_version`) folds in the port's toolchain
(the torch and CUDA versions and the port's own version) and the pipeline
config, so a cached *mask* can never be served back by a different
program: bump any of them and every entry misses by construction —
invalidation without TTLs, flush RPCs, or any notion of staleness. The
JAX package's version comes from its own toolchain
(``compilehub/persist.py::result_version``); the two never share a key.

Stdlib only, apart from :func:`result_version` reading the torch version.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Any, Dict, Optional

__all__ = ["ResultKey", "config_digest", "digest_bytes", "params_digest", "result_key",
           "result_version"]


def digest_bytes(data: bytes) -> str:
    """sha256 of the raw input body — the content-address half of the key.

    Full hex: the input digest is the identity clients can precompute and
    the dedup window compares; truncation buys nothing here.
    """
    return hashlib.sha256(data).hexdigest()


def params_digest(params: Optional[Dict[str, Any]]) -> str:
    """Canonical digest of request parameters (mirrors :func:`config_digest`).

    ``None`` and ``{}`` collapse to the same digest on purpose: "no
    parameters" is one identity, however the caller spells it.
    """
    payload = json.dumps(
        params or {}, sort_keys=True, default=repr, separators=(",", ":")
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class ResultKey:
    """The four-tuple identity of one cacheable result.

    Frozen: a key is a value. ``digest()`` is the store/index address —
    32 hex chars of sha256 over the canonical JSON form, collision-safe
    at any plausible store size.
    """

    input_digest: str
    algo: str  # "segment" | "segment-volume"
    params_digest: str
    program_version: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def digest(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:32]


def result_key(
    body: bytes,
    algo: str,
    params: Optional[Dict[str, Any]],
    program_version: str,
) -> ResultKey:
    """Build the key for one request: hash the body, digest the params."""
    return ResultKey(
        input_digest=digest_bytes(body),
        algo=algo,
        params_digest=params_digest(params),
        program_version=program_version,
    )


def config_digest(cfg: Any) -> str:
    """Stable digest of a pipeline config (the JAX package's
    ``compilehub.persist.config_digest``): a dataclass digests its sorted
    field dict, anything else its ``repr``."""
    if cfg is None:
        payload = "none"
    elif dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        payload = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=repr)
    else:
        payload = repr(cfg)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def _toolchain() -> tuple:
    import torch

    from nm03_capstone_project_tpu_torch import __version__

    return (
        ("torch_version", torch.__version__),
        ("cuda_version", str(torch.version.cuda)),
        ("nm03_torch_version", __version__),
    )


def result_version(cfg: Any = None) -> str:
    """The program-identity half of every result key: a sha256 over the
    port's toolchain and the config digest, 16 hex characters."""
    payload = {"cfg_digest": config_digest(cfg), **dict(_toolchain())}
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]
