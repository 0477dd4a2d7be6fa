"""Deadline-guarded dispatch with transient-error retries.

The port's copy of the JAX package's ``resilience/supervisor.py``, with
its fault-injection pre-hook and without its CPU degradation. A device dispatch that never returns cannot be
handled by containment (there is no exception to catch) or by retry (the
call never comes back). The :class:`DispatchSupervisor` runs it on an
expendable worker thread with a wall-clock
:class:`~.policy.Deadline`, and when the deadline expires *abandons* the
thread (daemonized, cancel-signalled) and raises
:class:`~.policy.DeadlineExceeded`.

The ladder, in order:

1. the dispatch succeeds — the normal path;
2. it raises a retryable (transient or CUDA runtime) error — retried under
   the :class:`~.policy.RetryPolicy` within the same deadline;
3. retries exhausted — the last error is raised; the deadline expires —
   ``DeadlineExceeded`` is raised.

The caller owns what follows: the serving executor quarantines the lane
(``serving/lanes.py``); the batch drivers fail the slice or the batch and
count it. There is no ``fallback=`` route: nothing here recomputes on the
CPU.

With ``dispatch_timeout_s == 0`` (the default) no worker threads exist and
dispatches run inline on the caller's thread, with retries only.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from nm03_capstone_project_tpu_torch.resilience.policy import (
    Deadline,
    DeadlineExceeded,
    ResilienceConfig,
    RetryPolicy,
    is_retryable,
)


class DispatchSupervisor:
    """Supervises the device dispatches of one serving lane or driver run."""

    def __init__(
        self,
        cfg: ResilienceConfig,
        retry: Optional[RetryPolicy] = None,
        obs=None,
    ):
        self.cfg = cfg
        self.retry = retry or cfg.make_retry_policy()
        self.obs = obs

    @property
    def supervised(self) -> bool:
        return self.cfg.dispatch_timeout_s > 0

    def run(
        self,
        primary: Callable[[], object],
        label: str = "dispatch",
        pre: Optional[Callable[[Optional[threading.Event]], None]] = None,
    ):
        """Run ``primary()`` under supervision and return its result.

        ``primary`` must perform the dispatch AND the device fetch, returning
        host-side results — the fetch is as wedgeable as the dispatch, so it
        must live inside the deadline. ``pre`` is the fault-injection seam
        (a ``dispatch`` rule of a :class:`~.faultinject.FaultPlan`): called
        before every attempt, inside the deadline and the retries, with the
        attempt's cancel event (None inline), so an injected hang blocks
        before any launch and dies with the abandoned thread.
        """
        if not self.supervised:
            def attempt():
                if pre is not None:
                    pre(None)
                return primary()

            return self.retry.call(attempt, cause=label, obs=self.obs)

        deadline = Deadline.start(self.cfg.dispatch_timeout_s)
        attempt = 0
        while True:
            status, value = self._attempt(primary, pre, deadline)
            if status == "ok":
                return value
            if status == "timeout":
                raise DeadlineExceeded(
                    f"{label} exceeded its {deadline.budget_s:.1f}s deadline"
                )
            err = value  # status == "err"
            if not is_retryable(err):
                raise err  # deterministic failure: the request's own
            attempt += 1
            delay = self.retry.delay_s(label, attempt)
            if (
                attempt > self.retry.retry_max
                or not self.retry.try_acquire(label)
                or delay >= deadline.remaining()
            ):
                raise err
            if self.obs is not None:
                self.obs.retry(
                    cause=label,
                    attempt=attempt,
                    error_class=type(err).__name__,
                    backoff_s=round(delay, 4),
                )
            time.sleep(delay)

    @staticmethod
    def _attempt(primary, pre, deadline: Deadline):
        box: dict = {}
        cancel = threading.Event()

        def work():
            try:
                if pre is not None:
                    pre(cancel)
                box["out"] = primary()
            except BaseException as e:  # noqa: BLE001 — crosses the thread
                box["err"] = e

        t = threading.Thread(target=work, daemon=True, name="nm03-dispatch")
        t.start()
        t.join(timeout=max(deadline.remaining(), 0.0))
        if t.is_alive():
            # abandon, never kill: the daemon thread dies with the process;
            # an injected hang honours `cancel` and returns before launching
            cancel.set()
            return ("timeout", None)
        if "err" in box:
            return ("err", box["err"])
        return ("ok", box.get("out"))
