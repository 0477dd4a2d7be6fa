"""Bounded in-memory result store: LRU by bytes, digest-verified reads.

The store holds opaque payload bytes (the serialized response the HTTP
layer would have produced) under a :class:`~.keys.ResultKey` digest. Two
properties the serving tier leans on:

* **Bounded by bytes, not entries.** Masks vary by orders of magnitude
  (a 2D slice vs a 32-plane volume); an entry-count LRU would let a few
  volumes blow the budget. ``fill`` evicts from the cold end until the
  new entry fits; an entry bigger than the whole budget is rejected
  outright (counted, never stored).

* **Verify-on-read.** Every ``lookup`` re-hashes the payload and compares
  against the ETag recorded at fill time. A mismatch (bit-rot, or a
  ``corrupt_hook`` drill) evicts the entry and reports a miss, so the
  caller recomputes: a corrupt entry costs one recompute, never a wrong
  answer.

The port's copy of the JAX package's ``cache/store.py``: the ETag is the
same function of the same bytes, so equal payloads carry equal ETags
across the two packages. Stdlib only; one lock.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "ResultEntry",
    "ResultStore",
    "content_etag",
    "etag_matches",
    "parse_bytes",
]


def content_etag(payload: bytes) -> str:
    """Strong HTTP ETag for a payload: quoted sha256 prefix.

    The ETag doubles as the integrity digest for verify-on-read, so it is
    derived from the bytes and nothing else — two bit-identical results
    always carry the same ETag, which is exactly what lets a client's
    ``If-None-Match`` revalidate across evict/refill cycles.
    """
    return '"' + hashlib.sha256(payload).hexdigest()[:32] + '"'


def etag_matches(if_none_match: Optional[str], etag: str) -> bool:
    """RFC 7232 ``If-None-Match`` against one strong ETag.

    ``*`` matches anything; otherwise the comma list is compared with the
    weak-comparison rule (a ``W/`` prefix on the client's copy still
    revalidates — the payload bytes it names are the same). Lives here,
    not in the HTTP layer, because every tier that answers a 304 needs it.
    """
    if not if_none_match or not etag:
        return False
    value = if_none_match.strip()
    if value == "*":
        return True
    for candidate in value.split(","):
        c = candidate.strip()
        if c.startswith("W/"):
            c = c[2:]
        if c == etag:
            return True
    return False


_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(text: str) -> int:
    """Parse a human byte size ('512m', '2g', '1048576') to an int."""
    s = str(text).strip().lower()
    if not s:
        raise ValueError("empty byte size")
    mult = 1
    if s[-1] in _SUFFIXES:
        mult = _SUFFIXES[s[-1]]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        raise ValueError(f"unparseable byte size: {text!r}") from None


@dataclass
class ResultEntry:
    """One stored result: payload bytes plus serving metadata."""

    digest: str  # ResultKey.digest() — the store address
    payload: bytes  # opaque serialized response
    etag: str  # content_etag(payload), recorded at fill
    algo: str  # "segment" | "segment-volume" (for ls/stats)
    meta: Dict[str, Any] = field(default_factory=dict)
    created: float = field(default_factory=time.time)
    hits: int = 0


class ResultStore:
    """Thread-safe LRU-by-bytes store of :class:`ResultEntry`.

    ``corrupt_hook(digest)`` is the corruption seam: when it returns truthy
    during ``lookup``, the payload is handed back with one byte flipped —
    the verify-on-read path must then evict and miss.

    ``on_evict(n)`` fires (outside any decision, inside the lock — it must
    be a cheap counter bump) whenever ``n`` entries leave the store, so the
    owner can keep ``serving_result_cache_evict_total`` honest.
    """

    def __init__(
        self,
        max_bytes: int,
        corrupt_hook: Optional[Callable[[str], bool]] = None,
        on_evict: Optional[Callable[[int], None]] = None,
    ):
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._corrupt_hook = corrupt_hook
        self._on_evict = on_evict
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, ResultEntry]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._fills = 0
        self._evictions = 0
        self._corrupt_evictions = 0
        self._oversize_rejects = 0

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, digest: str) -> Optional[ResultEntry]:
        """Return the live entry for ``digest``, or None (a miss).

        Verify-on-read: the payload is re-hashed under the lock; a digest
        mismatch evicts the entry and reports a miss so the caller
        recomputes. Hits move the entry to the hot end of the LRU.
        """
        with self._lock:
            entry = self._entries.get(digest)
            if entry is None:
                self._misses += 1
                return None
            payload = entry.payload
            if self._corrupt_hook is not None and self._corrupt_hook(digest):
                # simulate bit-rot without mutating the stored entry: the
                # verify below must catch the flipped byte
                flipped = bytearray(payload)
                if flipped:
                    flipped[0] ^= 0xFF
                payload = bytes(flipped)
            if content_etag(payload) != entry.etag:
                del self._entries[digest]
                self._bytes -= len(entry.payload)
                self._corrupt_evictions += 1
                self._evictions += 1
                self._misses += 1
                if self._on_evict is not None:
                    self._on_evict(1)
                return None
            self._entries.move_to_end(digest)
            entry.hits += 1
            self._hits += 1
            return entry

    def fill(
        self,
        digest: str,
        payload: bytes,
        algo: str,
        meta: Optional[Dict[str, Any]] = None,
    ) -> Tuple[Optional[ResultEntry], bool]:
        """Store a computed result; returns ``(entry, created)``.

        Idempotent on digest: a concurrent fill of the same key keeps the
        existing entry (``created=False``) — both payloads hash identically
        by construction, so there is nothing to reconcile. Oversize
        payloads (> max_bytes) are rejected and counted; LRU eviction from
        the cold end makes room otherwise.
        """
        size = len(payload)
        with self._lock:
            existing = self._entries.get(digest)
            if existing is not None:
                self._entries.move_to_end(digest)
                return existing, False
            if size > self.max_bytes:
                self._oversize_rejects += 1
                return None, False
            evicted = 0
            while self._bytes + size > self.max_bytes and self._entries:
                _, cold = self._entries.popitem(last=False)
                self._bytes -= len(cold.payload)
                evicted += 1
            if evicted:
                self._evictions += evicted
                if self._on_evict is not None:
                    self._on_evict(evicted)
            entry = ResultEntry(
                digest=digest,
                payload=payload,
                etag=content_etag(payload),
                algo=algo,
                meta=dict(meta or {}),
            )
            self._entries[digest] = entry
            self._bytes += size
            self._fills += 1
            return entry, True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lookups = self._hits + self._misses
            return {
                "enabled": True,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self._hits,
                "misses": self._misses,
                "fills": self._fills,
                "evictions": self._evictions,
                "corrupt_evictions": self._corrupt_evictions,
                "oversize_rejects": self._oversize_rejects,
                "hit_ratio": (self._hits / lookups) if lookups else None,
            }
