"""Failure injection, backoff, circuit breakers, and query retry.

Reference: execution/FailureInjector.java:62,125 (injected task failures for
fault-tolerance tests), RetryPolicy (operator/RetryPolicy.java) — NONE
(fail the query) vs QUERY (transparent re-execution), Backoff.java (the
capped exponential wait every remote-task poll sits behind), and the
failure-detection side of HttpRemoteTask: a worker that keeps failing stops
receiving traffic until a probe succeeds (circuit breaking).

Everything time-related is injectable (clock / sleep / rng) so chaos tests
run on a deterministic clock without real sleeps.

Port of trino_tpu/runtime/retry.py: a copy, with the package renamed.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


class InjectedFailure(RuntimeError):
    """Retryable injected fault (reference: TASK_FAILURE injection type)."""


class StageFailedException(RuntimeError):
    """A stage exhausted its task-retry budget.  Deliberately NOT retryable:
    consuming stages must propagate it instead of burning their own budgets
    (task budgets are per-task, not multiplicative — the reference fails the
    query when any task exceeds task_retry_attempts_per_task)."""


@dataclass
class _Injection:
    match: str  # substring of the injection point name
    error: Optional[type]  # None = latency injection (sleep, don't raise)
    remaining: int  # fire this many times, then stop
    delay_s: float = 0.0


class FailureInjector:
    """Named injection points call `maybe_fail(point)`; tests arm failures.

    Modes (reference: FailureInjector's TASK_FAILURE / TASK_TIMEOUT types):
      inject(...)                  — raise an error at the point
      inject_latency(...)          — stall the point (timeout/deadline chaos)
      inject_connection_flap(...)  — raise ConnectionResetError (the flaky-
                                     network shape retries must absorb)
    """

    def __init__(self, sleep: Callable[[float], None] = time.sleep):
        self._injections: list[_Injection] = []
        #: visit counter per injection point (lets fault-tolerance tests
        #: assert which stages re-ran and which were served from the spool)
        self.visits: dict[str, int] = {}
        #: injectable so latency tests don't really sleep; clear() restores
        #: THIS default (tests may also set .sleep directly per-case)
        self._default_sleep = sleep
        self.sleep = sleep

    def inject(self, match: str, times: int = 1, error: type = InjectedFailure):
        self._injections.append(_Injection(match, error, times))

    def inject_latency(self, match: str, delay_s: float, times: int = 1):
        """Stall matching points by delay_s (latency-spike chaos)."""
        self._injections.append(_Injection(match, None, times, delay_s))

    def inject_connection_flap(self, match: str, times: int = 1):
        """Drop matching connections (retryable ConnectionResetError)."""
        self._injections.append(_Injection(match, ConnectionResetError, times))

    def maybe_fail(self, point: str) -> None:
        self.visits[point] = self.visits.get(point, 0) + 1
        for inj in self._injections:
            if inj.remaining > 0 and inj.match in point:
                inj.remaining -= 1
                if inj.error is None:
                    self.sleep(inj.delay_s)
                    continue
                raise inj.error(f"injected failure at {point}")

    def clear(self) -> None:
        self._injections.clear()
        self.visits.clear()
        self.sleep = self._default_sleep


#: process-wide injector consulted by execution hooks (tests arm it)
FAILURE_INJECTOR = FailureInjector()

RETRYABLE = (InjectedFailure, ConnectionError, TimeoutError)


class Backoff:
    """Capped exponential backoff with FULL jitter (reference: Backoff.java;
    jitter per the AWS architecture-blog analysis — full jitter desynchronizes
    retry storms better than equal jitter).  attempt 0 waits in
    [0, base), attempt k in [0, min(cap, base * 2**k))."""

    def __init__(
        self,
        base_s: float = 0.05,
        cap_s: float = 5.0,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if base_s <= 0:
            raise ValueError(f"backoff base must be positive: {base_s}")
        self.base_s = base_s
        self.cap_s = cap_s
        self.rng = rng or random.Random()
        self._sleep = sleep
        #: total seconds slept (test/telemetry evidence)
        self.total_wait_s = 0.0

    def delay(self, attempt: int) -> float:
        """The jittered wait before retry number `attempt` (0-based)."""
        ceiling = min(self.cap_s, self.base_s * (2 ** max(0, attempt)))
        return self.rng.uniform(0.0, ceiling)

    def wait(self, attempt: int) -> float:
        d = self.delay(attempt)
        if d > 0:
            self._sleep(d)
        self.total_wait_s += d
        return d


# -- per-worker circuit breakers ----------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

#: numeric encoding for the metrics gauge (system.runtime.metrics)
BREAKER_STATE_CODES = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


class CircuitBreaker:
    """One worker's breaker: trips OPEN after `failure_threshold`
    CONSECUTIVE failures; after `cooldown_s` one half-open probe is allowed
    through — success closes the breaker, failure re-opens it (and restarts
    the cooldown)."""

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1: {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None

    def allow(self) -> bool:
        """May a request go to this worker now?  An OPEN breaker past its
        cooldown transitions to HALF_OPEN and admits ONE probe."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_HALF_OPEN:
                # one probe is already in flight; hold further traffic
                return False
            if self.clock() - self._opened_at >= self.cooldown_s:
                self.state = BREAKER_HALF_OPEN
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.state = BREAKER_CLOSED
            self._consecutive_failures = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if (
                self.state == BREAKER_HALF_OPEN
                or self._consecutive_failures >= self.failure_threshold
            ):
                tripped = self.state != BREAKER_OPEN
                self.state = BREAKER_OPEN
                self._opened_at = self.clock()
            else:
                tripped = False
        if tripped:
            from trino_tpu_torch.telemetry.metrics import breaker_trips_counter

            breaker_trips_counter().inc()

    def trip(self) -> None:
        """Force the breaker OPEN immediately (the heartbeat failure
        detector declared this worker DEAD: definitive evidence outranks
        the consecutive-failure count)."""
        with self._lock:
            tripped = self.state != BREAKER_OPEN
            self.state = BREAKER_OPEN
            self._consecutive_failures = max(
                self._consecutive_failures, self.failure_threshold
            )
            self._opened_at = self.clock()
        if tripped:
            from trino_tpu_torch.telemetry.metrics import breaker_trips_counter

            breaker_trips_counter().inc()


class CircuitBreakerRegistry:
    """Worker url -> breaker; surfaced as the
    `trino_tpu_breaker_state{worker=...}` gauge in system.runtime.metrics.

    Knobs default to the typed config (`breaker.failure-threshold` /
    `breaker.cooldown` with per-worker `@token` overrides, trino_tpu/config);
    explicit constructor values — tests, embedded registries — win over
    config.  Breakers are created lazily per worker, so a config installed
    after import still applies to workers seen afterwards."""

    def __init__(self, failure_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def _knobs_for(self, worker: str) -> tuple:
        """Each knob resolves independently: the explicit constructor value
        when given, the typed config (with per-worker overrides) otherwise
        — a registry pinning only one knob must not mute the config for
        the other."""
        cfg = None
        if self.failure_threshold is None or self.cooldown_s is None:
            from trino_tpu_torch.config import get_config

            cfg = get_config().breaker_for(worker)
        threshold = (
            self.failure_threshold
            if self.failure_threshold is not None
            else cfg.failure_threshold
        )
        cooldown = (
            self.cooldown_s if self.cooldown_s is not None else cfg.cooldown_s
        )
        return threshold, cooldown

    def get(self, worker: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(worker)
            if b is None:
                threshold, cooldown = self._knobs_for(worker)
                b = CircuitBreaker(threshold, cooldown, self.clock)
                self._breakers[worker] = b
            return b

    def states(self) -> dict:
        with self._lock:
            return {w: b.state for w, b in self._breakers.items()}

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()


#: process-wide breakers for the multi-host HTTP tier (one per worker url)
BREAKERS = CircuitBreakerRegistry()


def execute_with_retry(
    fn,
    retry_policy: str = "NONE",
    max_attempts: int = 4,
    backoff: Optional[Backoff] = None,
):
    """Run fn() under the given retry policy (reference:
    SqlQueryExecution's retry handling for retry_policy=QUERY).  TASK-level
    retry happens inside the stage executor (parallel/runner.py); at this
    outer level it degrades to a final QUERY-style safety net.

    Retries wait behind capped exponential backoff with full jitter —
    back-to-back re-execution of a query that just failed hammers whatever
    made it fail.  Lifecycle aborts (cancel/deadline/memory-kill) are
    deliberately NOT in RETRYABLE: an aborted query must never re-run."""
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1: {max_attempts}")
    if retry_policy == "NONE":
        return fn()
    assert retry_policy in ("QUERY", "TASK"), retry_policy
    if retry_policy == "TASK":
        # stage-level retry happens inside the stage executor; no outer
        # whole-query retries on top (reference: RetryPolicy.TASK)
        return fn()
    backoff = backoff or Backoff()
    last: Optional[BaseException] = None
    for attempt in range(max_attempts):
        if attempt:
            backoff.wait(attempt - 1)
        try:
            return fn()
        except RETRYABLE as e:
            last = e
    raise last
