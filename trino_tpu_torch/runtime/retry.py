"""Failure injection, backoff, circuit breakers, and query retry.

Reference: execution/FailureInjector.java:62,125 (injected task failures for
fault-tolerance tests), RetryPolicy (operator/RetryPolicy.java) — NONE
(fail the query) vs QUERY (transparent re-execution), Backoff.java (the
capped exponential wait every remote-task poll sits behind), and the
failure-detection side of HttpRemoteTask: a worker that keeps failing stops
receiving traffic until a probe succeeds (circuit breaking).

Everything time-related is injectable (clock / sleep / rng) so chaos tests
run on a deterministic clock without real sleeps.

Port of trino_tpu/runtime/retry.py: a copy, with the package renamed,
less the circuit breakers: they guard the multi-host HTTP tier, which is
not ported, so `CircuitBreaker` and `CircuitBreakerRegistry` raise
NotImplementedError and there is no process-wide `BREAKERS` registry.
"""

from __future__ import annotations

import random
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


# -- per-worker circuit breakers: not ported ----------------------------------


class CircuitBreaker:
    """A worker's circuit breaker guards the multi-host HTTP tier, which is
    not ported: constructing one raises NotImplementedError."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("circuit breakers (the multi-host HTTP tier): not ported yet")


class CircuitBreakerRegistry(CircuitBreaker):
    """Worker url -> breaker; not ported (see CircuitBreaker)."""


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
