"""Fleet admission policy: priority tiers, per-tenant fairness, shedding.

The single-engine :class:`~elephas_tpu_torch.serving.scheduler.Scheduler` is a
bounded priority+FIFO queue — correct for one partition, but blind to
WHO is asking. Under Zipf-skewed multi-tenant load, FIFO admission lets
the heaviest tenant starve everyone behind it, and a deep queue of
hopeless (deadline-unmeetable) work wastes the slots that live requests
need. This module is the fleet-level queue that sits in FRONT of the
partitions and fixes both:

- **Priority tiers**: strict — tier 1 (interactive) always dispatches
  before tier 0 (batch). Same contract as the engine scheduler's
  ``priority`` knob, applied fleet-wide.
- **Deficit round-robin (DRR) within a tier**: each tenant owns a FIFO
  and a deficit counter; a round-robin pointer visits tenants, tops the
  deficit up by ``quantum`` tokens, and dispatches head requests while
  the deficit covers their ``max_new`` cost. Heavy requests simply
  consume more visits — a tenant submitting 10× the traffic gets its
  fair token share, not 10× the service. Deficits are capped at one
  quantum when a tenant's queue drains (an idle tenant banks no credit,
  the classic DRR rule).
- **Token-bucket rate limits**: optional per-tenant ``rate_limit``
  (tokens/s, burst-capped). A tenant over its rate is SKIPPED, not
  shed — its queue waits for refill, bounded by the deadline check.
- **Deadline shedding**: at every poll, requests whose deadline is
  provably unmeetable (expired, or remaining budget × the fleet's
  ``itl_estimate_s`` floor overruns it) are shed with reason
  ``"deadline"``; a queue past ``max_queue_per_tenant`` sheds from the
  BACK with ``"overload"`` (newest-dropped: the oldest waiting request
  is closest to its deadline and most worth finishing).

The policy is pure host-side bookkeeping on the injected clock — no
wall reads, no randomness — so a trace replay through it is
deterministic. The router drains it with :meth:`poll` and returns
failed dispatches via :meth:`push_front`.

A copy of ``elephas_tpu/fleet/policy.py``.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from .traffic import TraceRequest


@dataclass
class _TokenBucket:
    """Standard token bucket: ``rate`` tokens/s, capacity ``burst``."""

    rate: float
    burst: float
    tokens: float = 0.0
    last: float = 0.0

    def try_take(self, now: float, cost: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


@dataclass
class _TenantState:
    queue: Deque[TraceRequest] = field(default_factory=deque)
    deficit: float = 0.0
    bucket: Optional[_TokenBucket] = None
    # lifetime accounting, surfaced in snapshot()
    enqueued: int = 0
    dispatched: int = 0
    shed: int = 0


class FleetPolicy:
    """Fleet-level admission queue: strict priority tiers, DRR fairness
    per tenant within a tier, per-tenant rate limits, deadline shedding.

    ``quantum`` is the DRR refill in TOKENS (a request costs its
    ``max_new``); ``itl_estimate_s`` is the per-token latency floor used
    for the unmeetable-deadline proof (``None`` sheds only
    already-expired deadlines); ``max_queue_per_tenant`` bounds each
    tenant's backlog (backpressure, shed-from-back).
    """

    def __init__(self, *, quantum: float = 8.0,
                 itl_estimate_s: Optional[float] = None,
                 max_queue_per_tenant: int = 256,
                 rate_limits: Optional[Dict[int, Tuple[float, float]]] = None):
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        if max_queue_per_tenant < 1:
            raise ValueError("max_queue_per_tenant must be >= 1")
        if itl_estimate_s is not None and itl_estimate_s <= 0:
            raise ValueError("itl_estimate_s must be > 0 when given")
        self.quantum = float(quantum)
        self.itl_estimate_s = itl_estimate_s
        self.max_queue_per_tenant = int(max_queue_per_tenant)
        self._rate_limits = dict(rate_limits or {})
        # tier -> OrderedDict[tenant -> _TenantState]; OrderedDict gives
        # the deterministic round-robin visit order (insertion order,
        # rotated via move_to_end)
        self._tiers: Dict[int, "OrderedDict[int, _TenantState]"] = {}
        self.total_queued = 0

    # -- intake -----------------------------------------------------------
    def _tenant(self, tier: int, tenant: int) -> _TenantState:
        tiers = self._tiers.setdefault(int(tier), OrderedDict())
        st = tiers.get(int(tenant))
        if st is None:
            st = _TenantState()
            lim = self._rate_limits.get(int(tenant))
            if lim is not None:
                rate, burst = lim
                st.bucket = _TokenBucket(rate=float(rate),
                                         burst=float(burst),
                                         tokens=float(burst))
            tiers[int(tenant)] = st
        return st

    def submit(self, req: TraceRequest, now: float) -> Optional[str]:
        """Enqueue ``req``. Returns ``None`` on success or a shed reason
        (``"overload"``) if the tenant's backlog is full — the caller
        owns the terminal record for a shed."""
        st = self._tenant(req.priority, req.tenant)
        if st.bucket is not None and st.bucket.last == 0.0:
            st.bucket.last = now  # first sighting anchors the refill
        if len(st.queue) >= self.max_queue_per_tenant:
            st.shed += 1
            return "overload"
        st.queue.append(req)
        st.enqueued += 1
        self.total_queued += 1
        return None

    def push_front(self, req: TraceRequest) -> None:
        """Return a request the router failed to dispatch (partition
        full / died before prefill) to the FRONT of its tenant queue —
        it already waited its turn once."""
        st = self._tenant(req.priority, req.tenant)
        st.queue.appendleft(req)
        self.total_queued += 1

    # -- deadline math ----------------------------------------------------
    def _unmeetable(self, req: TraceRequest, now: float) -> bool:
        if req.deadline_s is None:
            return False
        deadline_at = req.arrival_s + req.deadline_s
        if now >= deadline_at:
            return True
        return (self.itl_estimate_s is not None
                and now + req.max_new * self.itl_estimate_s > deadline_at)

    # -- dispatch ---------------------------------------------------------
    def poll(self, now: float) -> Optional[Tuple[str, TraceRequest]]:
        """The next policy action, or ``None`` when nothing is
        dispatchable right now. Returns ``("shed", req)`` for a request
        whose deadline is provably unmeetable (shed before it costs any
        partition a slot), else ``("dispatch", req)`` for the DRR pick.
        Call repeatedly until ``None`` to drain what the clock allows."""
        for tier in sorted(self._tiers, reverse=True):
            tiers = self._tiers[tier]
            # Round-robin sweeps over this tier's tenants. A sweep where
            # some tenant accrued deficit but could not yet afford its
            # head is PROGRESS — sweep again (deficit strictly grows
            # toward the head's cost, so this terminates). A sweep with
            # no accrual (empty or rate-limited tenants only) falls
            # through to the next tier — strict priority, but a tier
            # that CAN'T dispatch never blocks one that can.
            progressed = True
            while progressed:
                progressed = False
                for _ in range(len(tiers)):
                    tenant, st = next(iter(tiers.items()))
                    tiers.move_to_end(tenant)
                    if not st.queue:
                        st.deficit = 0.0  # idle tenants bank no credit
                        continue
                    # shed hopeless work first — it never costs deficit
                    if self._unmeetable(st.queue[0], now):
                        req = st.queue.popleft()
                        self.total_queued -= 1
                        st.shed += 1
                        return ("shed", req)
                    req = st.queue[0]
                    cost = float(req.max_new)
                    if st.bucket is not None and not st.bucket.try_take(
                            now, cost):
                        continue  # over rate: wait for refill, keep queue
                    st.deficit = min(st.deficit + self.quantum,
                                     self.quantum + cost)
                    if st.deficit < cost:
                        progressed = True
                        continue  # not this visit — deficit carries over
                    st.deficit -= cost
                    st.queue.popleft()
                    self.total_queued -= 1
                    st.dispatched += 1
                    return ("dispatch", req)
        return None

    # -- observability ----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self.total_queued

    def snapshot(self) -> Dict[str, Any]:
        """Per-tenant fairness state: queue depth, DRR deficit credit,
        rate-bucket fill, lifetime enqueue/dispatch/shed counts."""
        tenants: Dict[str, Any] = {}
        for tier in sorted(self._tiers, reverse=True):
            for tenant, st in self._tiers[tier].items():
                tenants[str(tenant)] = {
                    "tier": tier,
                    "queued": len(st.queue),
                    "deficit": round(st.deficit, 3),
                    "rate_tokens": (None if st.bucket is None
                                    else round(st.bucket.tokens, 3)),
                    "enqueued": st.enqueued,
                    "dispatched": st.dispatched,
                    "shed": st.shed,
                }
        return {"queued": self.total_queued, "tenants": tenants}
