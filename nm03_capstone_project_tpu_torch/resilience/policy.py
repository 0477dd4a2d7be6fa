"""Retry and deadline policy objects.

The port's copy of the JAX package's ``resilience/policy.py``. Containment
(catch, log, move on) handles *deterministic* failures; a device dispatch
can also fail *transiently* (errors once, succeeds on retry) or
*unboundedly* (never returns). These two policy objects give those failure
modes first-class semantics:

* :class:`RetryPolicy` — bounded exponential backoff with deterministic
  jitter and per-cause run-level retry budgets, so one flapping cause
  cannot spend the whole run's wall clock retrying;
* :class:`Deadline` — a wall-clock budget for one device dispatch batch,
  the unit the :class:`~.supervisor.DispatchSupervisor` abandons when it
  expires.

Stdlib only.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type


class TransientDeviceError(RuntimeError):
    """A device-side failure worth retrying (and, exhausted, quarantining a
    serving lane on). PyTorch surfaces CUDA runtime errors as
    ``torch.AcceleratorError``, which :func:`is_retryable` classifies too.
    """


class DeadlineExceeded(TimeoutError):
    """A supervised dispatch outlived its wall-clock budget."""


def is_retryable(exc: BaseException, extra: Tuple[Type[BaseException], ...] = ()) -> bool:
    """Transient-or-device-runtime classification for dispatch errors.

    Matches :class:`TransientDeviceError` (and subclasses), any class in
    ``extra``, and — by name, so this module imports no torch — the CUDA
    runtime error type a lost or faulted card raises.
    """
    if isinstance(exc, (TransientDeviceError, *extra)):
        return True
    return any(k.__name__ == "AcceleratorError" for k in type(exc).__mro__)


@dataclasses.dataclass(frozen=True)
class Deadline:
    """Wall-clock budget for one supervised operation (monotonic clock).

    ``budget_s <= 0`` means *no deadline* (remaining is infinite) so callers
    can thread one object unconditionally.
    """

    budget_s: float
    started_mono: float

    @classmethod
    def start(cls, budget_s: float) -> "Deadline":
        return cls(budget_s=float(budget_s), started_mono=time.monotonic())

    @property
    def enabled(self) -> bool:
        return self.budget_s > 0

    def elapsed(self) -> float:
        return time.monotonic() - self.started_mono

    def remaining(self) -> float:
        if not self.enabled:
            return float("inf")
        return self.budget_s - self.elapsed()

    def expired(self) -> bool:
        return self.enabled and self.remaining() <= 0

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"{what} exceeded its {self.budget_s:.1f}s deadline"
            )


class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter + cause budgets.

    ``retry_max`` is the number of *retries* after the first attempt (0
    disables retrying). ``budget_per_cause`` caps total retries per cause
    string across the whole run — thousands of requests must not multiply
    a persistent failure into thousands of backoff waits.

    Jitter is deterministic: the delay for (cause, attempt) is derived from
    ``seed`` alone, so two runs sleep the same schedule.

    Thread-safe: every serving lane retries through one policy each, and
    probation probes take their own.
    """

    def __init__(
        self,
        retry_max: int = 2,
        backoff_s: float = 0.05,
        multiplier: float = 2.0,
        max_backoff_s: float = 5.0,
        jitter: float = 0.5,
        budget_per_cause: int = 64,
        seed: int = 0,
        obs=None,
    ):
        if retry_max < 0:
            raise ValueError(f"retry_max must be >= 0, got {retry_max}")
        if backoff_s < 0 or max_backoff_s < 0:
            raise ValueError("backoff times must be >= 0")
        if multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {multiplier}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.retry_max = int(retry_max)
        self.backoff_s = float(backoff_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.budget_per_cause = int(budget_per_cause)
        self.seed = int(seed)
        # default telemetry target for call(): set once by the owner
        self.obs = obs
        self._lock = threading.Lock()
        self._spent: Dict[str, int] = {}

    # -- schedule ----------------------------------------------------------

    def delay_s(self, cause: str, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based) of ``cause``."""
        base = min(
            self.backoff_s * (self.multiplier ** max(attempt - 1, 0)),
            self.max_backoff_s,
        )
        if self.jitter == 0.0 or base == 0.0:
            return base
        rng = random.Random(f"{self.seed}:{cause}:{attempt}")
        # full-jitter fraction: delay in [base*(1-j), base]
        return base * (1.0 - self.jitter * rng.random())

    # -- budget accounting -------------------------------------------------

    def spent(self, cause: str) -> int:
        with self._lock:
            return self._spent.get(cause, 0)

    def try_acquire(self, cause: str) -> bool:
        """Reserve one retry from ``cause``'s run-level budget."""
        with self._lock:
            if self._spent.get(cause, 0) >= self.budget_per_cause:
                return False
            self._spent[cause] = self._spent.get(cause, 0) + 1
            return True

    # -- execution ---------------------------------------------------------

    def call(
        self,
        fn: Callable,
        *args,
        cause: str,
        retryable: Tuple[Type[BaseException], ...] = (),
        obs=None,
        deadline: Optional[Deadline] = None,
        sleep: Callable[[float], None] = time.sleep,
        **kwargs,
    ):
        """Run ``fn(*args, **kwargs)`` under this policy.

        Retries only exceptions :func:`is_retryable` classifies (plus any in
        ``retryable``); everything else propagates on first raise — a
        deterministic failure must fail its request, not spend the backoff
        schedule. ``obs`` (a RunContext) receives one
        ``retry`` record per actual retry. A ``deadline`` caps the whole
        attempt sequence: no retry is launched past its expiry.
        """
        if obs is None:
            obs = self.obs
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                attempt += 1
                if not is_retryable(e, extra=retryable):
                    raise
                if attempt > self.retry_max:
                    raise
                if deadline is not None and deadline.expired():
                    raise
                if not self.try_acquire(cause):
                    raise
                delay = self.delay_s(cause, attempt)
                if deadline is not None and delay >= deadline.remaining():
                    raise
                if obs is not None:
                    obs.retry(
                        cause=cause,
                        attempt=attempt,
                        error_class=type(e).__name__,
                        backoff_s=round(delay, 4),
                    )
                sleep(delay)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """The serving executor's resilience knobs, in one object.

    The JAX package's ``fallback_cpu`` and ``fault_plan`` are not here: the
    port has no CPU fallback (a dispatch that outlives its deadline
    quarantines its lane, and with every lane quarantined requests fail
    fast), and fault plans are not ported yet.
    """

    retry_max: int = 2
    retry_backoff_s: float = 0.05
    dispatch_timeout_s: float = 0.0  # 0 = unsupervised (inline) dispatch

    def make_retry_policy(self, seed: int = 0) -> RetryPolicy:
        return RetryPolicy(
            retry_max=self.retry_max,
            backoff_s=self.retry_backoff_s,
            seed=seed,
        )
