"""In-flight request coalescing index for volume serving.

The port's copy of the JAX package's ``cache/inflight.py``. The store
answers "has this result been computed?"; this index answers "is this
result being computed *right now*?" — the window between those two is
where a retry storm re-runs a 32-plane gang program. A volume request
registers its leader here before dispatch; an identical request (same
content digest, or the same ``X-Nm03-Idempotency-Key``) arriving
mid-flight claims the leader and waits on *its* completion instead of
dispatching a second gang.

Aliases are the idempotency-key seam: ``register(digest, req,
alias="idem:K")`` records ``K -> digest`` in a bounded map that OUTLIVES
the in-flight window, so a client retry after the gang has already
finished and released still resolves ``K`` to the content digest and
finds the stored result. The alias map is advisory (bounded FIFO, oldest
dropped): losing an alias degrades to a recompute, never a wrong answer.

Stdlib only; one lock. The leader objects held here are opaque to this
module (the server hands in its VolumeRequest and joins on it itself).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

__all__ = ["InflightIndex"]

_MAX_ALIASES = 4096


class InflightIndex:
    """digest -> in-flight leader, plus a bounded alias (idem-key) map."""

    def __init__(self, max_aliases: int = _MAX_ALIASES):
        self._lock = threading.Lock()
        self._leaders: Dict[str, Any] = {}
        self._aliases: "OrderedDict[str, str]" = OrderedDict()
        self._max_aliases = int(max_aliases)
        self._coalesced = 0

    def resolve(self, alias: str) -> Optional[str]:
        """Map an idempotency key to the content digest it last named."""
        with self._lock:
            return self._aliases.get(alias)

    def claim(self, digest: str) -> Optional[Any]:
        """Return the live leader for ``digest``, or None if none in flight."""
        with self._lock:
            leader = self._leaders.get(digest)
            if leader is not None:
                self._coalesced += 1
            return leader

    def register(self, digest: str, req: Any, alias: Optional[str] = None) -> Any:
        """Install ``req`` as the leader for ``digest`` (first wins).

        Returns the installed leader: ``req`` itself, or an existing
        leader if one beat us to it — the caller must then join on the
        returned object instead of dispatching. The alias mapping is
        recorded either way (and persists after release).
        """
        with self._lock:
            if alias is not None:
                self._aliases[alias] = digest
                self._aliases.move_to_end(alias)
                while len(self._aliases) > self._max_aliases:
                    self._aliases.popitem(last=False)
            existing = self._leaders.get(digest)
            if existing is not None:
                self._coalesced += 1
                return existing
            self._leaders[digest] = req
            return req

    def release(self, digest: str) -> None:
        """Remove the leader once its result is filled (or failed)."""
        with self._lock:
            self._leaders.pop(digest, None)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "in_flight": len(self._leaders),
                "aliases": len(self._aliases),
                "coalesced": self._coalesced,
            }
