"""Retry policies and circuit breaking for parameter-server traffic.

Two composable pieces:

- :class:`RetryPolicy` — exponential backoff with deterministic jitter,
  attempt caps, and an overall deadline. Pure-ish: delays come from a
  seeded hash keyed by (seed, attempt), and both the clock and the sleep
  function are injectable, so tests pin exact schedules without waiting.
- :class:`CircuitBreaker` — classic closed → open → half-open state
  machine. After ``failure_threshold`` consecutive failures, calls
  fail-fast with :class:`CircuitOpenError` for ``reset_timeout_s``; then
  one probe call is admitted (half-open) and its outcome closes or
  re-opens the circuit. Fail-fast matters in hogwild mode: a dead server
  should cost a worker microseconds per step, not a 60s socket timeout
  per push.

:class:`ResilientClient` composes both around any
:class:`~elephas_tpu_torch.parameter.client.BaseParameterClient`: every pull and
push routes through breaker → retry → transport. Only *transient* errors
(:func:`default_is_transient`: connection resets, timeouts, HTTP 5xx-ish
``URLError``/``OSError``) are retried; anything else — including an
injected :class:`~elephas_tpu_torch.resilience.faults.InjectedWorkerCrash` — is
a crash and propagates immediately.

A copy of ``elephas_tpu/resilience/policy.py`` over the port's clients.
"""

from __future__ import annotations

import hashlib
import socket
import threading
import time
import urllib.error
from typing import Callable, Optional, TypeVar

from ..parameter.client import BaseParameterClient

T = TypeVar("T")


class RetryExhausted(RuntimeError):
    """All attempts failed (cap or deadline hit). ``__cause__`` is the
    last underlying error."""


class CircuitOpenError(ConnectionError):
    """Fail-fast rejection: the breaker is open, the call never went out."""


def default_is_transient(err: BaseException) -> bool:
    """Errors worth retrying: the network hiccupped, not the program.

    ``ConnectionError`` covers refused/reset/aborted plus injected
    :class:`~elephas_tpu_torch.resilience.faults.TransientFault`; ``socket.timeout``
    and ``urllib.error.URLError`` are how the HTTP/socket clients surface
    slow or flapping servers; other ``OSError`` s (EPIPE, unreachable) round
    it out. ``CircuitOpenError`` is deliberately transient: a later attempt
    may find the breaker half-open.
    """
    if isinstance(err, (ConnectionError, socket.timeout, TimeoutError)):
        return True
    if isinstance(err, urllib.error.URLError):
        return True
    return isinstance(err, OSError)


def _jitter_unit(seed: int, attempt: int) -> float:
    digest = hashlib.blake2b(
        f"retry:{seed}:{attempt}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2.0**64


class RetryPolicy:
    """Exponential backoff + jitter with attempt caps and deadlines.

    ``delay(attempt)`` for attempt k (0-based failure count) is
    ``min(base * mult**k, max_delay) * (1 - jitter * u)`` where ``u`` is a
    deterministic uniform draw from (seed, k) — full reproducibility with
    the decorrelation jitter buys in aggregate.
    """

    def __init__(self, *,
                 max_attempts: int = 5,
                 base_delay_s: float = 0.05,
                 multiplier: float = 2.0,
                 max_delay_s: float = 2.0,
                 jitter: float = 0.5,
                 deadline_s: Optional[float] = None,
                 seed: int = 0,
                 is_transient: Callable[[BaseException], bool] = default_is_transient,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self.seed = int(seed)
        self.is_transient = is_transient
        self.sleep = sleep
        self.clock = clock

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt + 1`` (attempt is the
        0-based count of failures so far)."""
        raw = min(
            self.base_delay_s * self.multiplier ** attempt, self.max_delay_s
        )
        return raw * (1.0 - self.jitter * _jitter_unit(self.seed, attempt))

    def call(self, fn: Callable[[], T], *, describe: str = "call") -> T:
        """Run ``fn``, retrying transient failures per the schedule.

        Raises :class:`RetryExhausted` when the attempt cap or deadline is
        hit; re-raises non-transient errors immediately.
        """
        start = self.clock()
        last_err: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except BaseException as err:  # noqa: BLE001 - filtered below
                if not self.is_transient(err):
                    raise
                last_err = err
            if attempt + 1 >= self.max_attempts:
                break
            pause = self.delay(attempt)
            if (self.deadline_s is not None
                    and self.clock() - start + pause > self.deadline_s):
                raise RetryExhausted(
                    f"{describe}: deadline {self.deadline_s}s exceeded "
                    f"after {attempt + 1} attempt(s)"
                ) from last_err
            if pause > 0.0:
                self.sleep(pause)
        raise RetryExhausted(
            f"{describe}: all {self.max_attempts} attempt(s) failed"
        ) from last_err


class CircuitBreaker:
    """Closed → open → half-open breaker, thread-safe.

    Hogwild workers share one breaker per client stack: the first worker
    to burn ``failure_threshold`` consecutive failures opens it for
    everyone, and every call during the open window costs only a lock and
    a clock read.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *,
                 failure_threshold: int = 5,
                 reset_timeout_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if (self._state == self.OPEN
                and self.clock() - self._opened_at >= self.reset_timeout_s):
            self._state = self.HALF_OPEN
            self._probing = False

    def allow(self) -> bool:
        """Admit one call? Half-open admits exactly one probe at a time."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._trip()
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._trip()

    def _trip(self) -> None:
        # caller holds the lock
        self._state = self.OPEN
        self._failures = 0
        self._probing = False
        self._opened_at = self.clock()

    def call(self, fn: Callable[[], T]) -> T:
        if not self.allow():
            raise CircuitOpenError("circuit breaker is open")
        try:
            result = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result


class FailoverClient(BaseParameterClient):
    """Multi-endpoint parameter client: primary + hot standbys.

    Wraps an ordered list of endpoint clients (endpoint 0 = primary) with a
    circuit breaker per endpoint. Every operation tries the active endpoint
    first; when it fails transiently (or its breaker is open), the call
    fails over to the next endpoint in order — transparently, within the
    same logical call. The caller never learns the primary died.

    Staleness bound on failover: the client tracks the highest weight
    *version* it has observed (parameter servers expose a monotonic update
    counter — :meth:`~elephas_tpu_torch.parameter.client.BaseParameterClient.
    get_version`). When traffic moves to a standby, the client polls the
    standby's version until it has caught up to the last observed version
    (or ``staleness_wait_s`` elapses, since an abruptly killed primary may
    have applied updates that never left its replication queue). So reads
    after failover are bounded-stale, not arbitrarily stale.

    Failovers are observable: ``failovers`` counts them, and a
    :class:`~elephas_tpu_torch.resilience.membership.HeartbeatRegistry` passed as
    ``registry`` receives an event per failover (surfaced in its JSON
    snapshot).

    Push semantics across failover are at-least-once, exactly like a plain
    retried push: a push that timed out on the dying primary may have been
    applied and replicated before the client re-sends it to the standby.
    Attempt-tagged pushes stay bounded by the server's rollback/fence
    machinery; untagged pushes inherit the reference's documented
    at-least-once contract.
    """

    def __init__(self, endpoints, *,
                 breakers=None,
                 failure_threshold: int = 2,
                 reset_timeout_s: float = 5.0,
                 registry=None,
                 staleness_wait_s: float = 2.0,
                 poll_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 is_transient: Callable[[BaseException], bool] = default_is_transient):
        if not endpoints:
            raise ValueError("FailoverClient needs at least one endpoint")
        self.endpoints = list(endpoints)
        self.breakers = (
            list(breakers) if breakers is not None
            else [CircuitBreaker(failure_threshold=failure_threshold,
                                 reset_timeout_s=reset_timeout_s,
                                 clock=clock)
                  for _ in self.endpoints]
        )
        if len(self.breakers) != len(self.endpoints):
            raise ValueError("one breaker per endpoint")
        self.registry = registry
        self.staleness_wait_s = float(staleness_wait_s)
        self.poll_s = float(poll_s)
        self.sleep = sleep
        self.clock = clock
        self.is_transient = is_transient
        self._lock = threading.Lock()
        self._active = 0
        self._last_version = -1
        self.failovers = 0

    @property
    def active_endpoint(self) -> int:
        with self._lock:
            return self._active

    def _note_version(self, endpoint) -> None:
        seen = getattr(endpoint, "last_seen_version", -1)
        if seen is None:
            return
        with self._lock:
            if seen > self._last_version:
                self._last_version = int(seen)

    def _await_catchup(self, endpoint) -> None:
        """Bound read staleness: wait (briefly) for the standby's version
        counter to reach the last version this client observed."""
        with self._lock:
            target = self._last_version
        if target < 0 or self.staleness_wait_s <= 0:
            return
        deadline = self.clock() + self.staleness_wait_s
        while True:
            try:
                version = endpoint.get_version()
                if version < 0 or version >= target:
                    # <0 = backend exposes no version counter: staleness
                    # cannot be bounded, don't burn the wait budget on it
                    return
            except BaseException as err:  # noqa: BLE001 - transient probe
                if not self.is_transient(err):
                    raise
            if self.clock() >= deadline:
                return
            self.sleep(self.poll_s)

    def _failover_to(self, index: int) -> None:
        with self._lock:
            if self._active == index:
                return
            self._active = index
            self.failovers += 1
            version = self._last_version
        if self.registry is not None:
            self.registry.observe_failover(
                endpoint=index, version=None if version < 0 else version
            )

    def _run(self, op: Callable[[BaseParameterClient], T], describe: str) -> T:
        with self._lock:
            start = self._active
        last_err: Optional[BaseException] = None
        for k in range(len(self.endpoints)):
            i = (start + k) % len(self.endpoints)
            endpoint, breaker = self.endpoints[i], self.breakers[i]
            if not breaker.allow():
                last_err = CircuitOpenError(
                    f"{describe}: endpoint {i} breaker is open"
                )
                continue
            if i != start:
                self._await_catchup(endpoint)
            try:
                result = op(endpoint)
            except BaseException as err:  # noqa: BLE001 - filtered below
                breaker.record_failure()
                if not self.is_transient(err):
                    raise
                last_err = err
                continue
            breaker.record_success()
            if i != start:
                self._failover_to(i)
            self._note_version(endpoint)
            return result
        assert last_err is not None
        raise last_err

    def get_parameters(self):
        return self._run(lambda c: c.get_parameters(), "get_parameters")

    def get_version(self) -> int:
        return self._run(lambda c: c.get_version(), "get_version")

    def update_parameters(self, delta) -> None:
        self._run(lambda c: c.update_parameters(delta), "update_parameters")

    def update_parameters_tagged(self, task_id: str, delta,
                                 attempt=None) -> None:
        if attempt is None:
            self._run(lambda c: c.update_parameters_tagged(task_id, delta),
                      "update_parameters_tagged")
        else:
            self._run(
                lambda c: c.update_parameters_tagged(
                    task_id, delta, attempt=attempt
                ),
                "update_parameters_tagged",
            )

    def register_attempt(self, task_id: str, attempt: int) -> bool:
        return self._run(
            lambda c: c.register_attempt(task_id, attempt), "register_attempt"
        )

    def commit_attempt(self, task_id: str) -> None:
        self._run(lambda c: c.commit_attempt(task_id), "commit_attempt")

    def close(self) -> None:
        for endpoint in self.endpoints:
            try:
                endpoint.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass


class ResilientClient(BaseParameterClient):
    """Route a parameter client's traffic through breaker → retry.

    The breaker sits INSIDE the retry loop: an open circuit surfaces as a
    transient :class:`CircuitOpenError`, so the retry policy backs off
    across the breaker's reset window instead of giving up instantly —
    a worker rides out a brief server outage with a handful of cheap
    rejections, then resumes on the half-open probe.
    """

    def __init__(self, inner: BaseParameterClient,
                 policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.breaker = breaker

    def _guarded(self, fn: Callable[[], T], describe: str) -> T:
        if self.breaker is None:
            return self.policy.call(fn, describe=describe)
        return self.policy.call(
            lambda: self.breaker.call(fn), describe=describe
        )

    def get_parameters(self):
        return self._guarded(self.inner.get_parameters, "get_parameters")

    def update_parameters(self, delta) -> None:
        self._guarded(
            lambda: self.inner.update_parameters(delta), "update_parameters"
        )

    def update_parameters_tagged(self, task_id: str, delta,
                                 attempt=None) -> None:
        # Forward the attempt tag only when set so plain two-arg inner
        # clients keep working unchanged.
        if attempt is None:
            self._guarded(
                lambda: self.inner.update_parameters_tagged(task_id, delta),
                "update_parameters_tagged",
            )
        else:
            self._guarded(
                lambda: self.inner.update_parameters_tagged(
                    task_id, delta, attempt=attempt
                ),
                "update_parameters_tagged",
            )

    def get_version(self) -> int:
        return self._guarded(self.inner.get_version, "get_version")

    def register_attempt(self, task_id: str, attempt: int) -> bool:
        return self._guarded(
            lambda: self.inner.register_attempt(task_id, attempt),
            "register_attempt",
        )

    def commit_attempt(self, task_id: str) -> None:
        self._guarded(
            lambda: self.inner.commit_attempt(task_id), "commit_attempt"
        )

    def close(self) -> None:
        self.inner.close()
