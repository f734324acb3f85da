"""FleetRouter: N serving partitions behind one membership-governed door.

The router is the fleet's control plane. It owns three loops that the
single-engine repo previously had no home for:

- **Placement**: requests drain from the :class:`FleetPolicy` (which
  owns fairness and shedding) to the least-loaded LIVE partition —
  live per the :class:`~elephas_tpu_torch.resilience.membership.HeartbeatRegistry`,
  least-loaded by free slots. Dispatch only targets partitions with a
  free slot and an empty engine queue: the fleet queue is THE queue, so
  fairness decisions are made in one place and a partition death
  strands at most its admitted slots, never a deep private backlog.
- **Membership + migration**: every partition holds a lease
  (``serve-<pid>``) the router heartbeats while the engine is healthy.
  A killed partition stops beating, the sweep expires its lease, the
  membership EPOCH changes, and the router rebalances: every in-flight
  request stranded on a dead partition is requeued at the front of its
  tenant queue and re-dispatched with ``prompt ++ generated`` and its
  ORIGINAL sampling seed. Token selection is keyed by (seed, absolute
  position), so the migrated stream is bitwise identical to the stream
  the dead partition would have produced — migration is invisible in
  the tokens, only visible in the latency tail. Graceful
  :meth:`retire_partition` does the same migration eagerly (lease
  surrendered via ``leave``, requests cancelled and requeued) so the
  autoscaler can shrink the fleet without losing work.
- **Aggregation**: :meth:`snapshot` folds per-partition engine metrics
  into fleet p50/p99 TTFT and inter-token latency, SLO attainment vs
  offered load, and per-tenant accounting (tokens, admitted/shed, DRR
  credit) — the observable surface the judged bench asserts against.

Weight rollover rides the same surface: :meth:`swap_params` fans a new
params tree out to every live partition between steps, remembers it for
partitions that join later, and :func:`router_sink` adapts the router
into a :class:`~elephas_tpu_torch.streaming.publisher.WeightPublisher` sink so
the train-to-serve stream updates the WHOLE fleet, not one engine.

Everything runs on ONE injected clock shared by engines, registry,
policy, and router (:class:`~elephas_tpu_torch.fleet.traffic.SimClock` in
tests and replay; ``time.monotonic`` in real deployments), which is what
makes a chaos scenario — kill a partition mid-burst, join a replacement,
assert the p99 deadline-miss bound and zero token divergence — a
deterministic tier-1 test instead of a flaky integration suite.

A copy of ``elephas_tpu/fleet/router.py`` over the port's
:class:`~elephas_tpu_torch.resilience.membership.HeartbeatRegistry`,
:class:`~elephas_tpu_torch.serving.scheduler.AdmissionError` and
:class:`~elephas_tpu_torch.serving.engine.ServingEngine`. Partitions on one
card may share one params dict (the factory's choice); each keeps its own
cache. On the card, a migrated request's next tokens come from a prefill
and the undisturbed stream's from decode steps, which attend through other
kernels and sum in another order: there the two streams agree up to near
ties; on the CPU they agree bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..resilience.membership import HeartbeatRegistry
from ..serving.scheduler import AdmissionError
from .policy import FleetPolicy
from .traffic import Trace, TraceRequest

OK_REASONS = ("eos", "length")


def _percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not xs:
        return None
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(np.ceil(q / 100.0 * len(s))) - 1))
    return float(s[idx])


@dataclass
class _ReqState:
    """Router-side lifecycle record for one fleet request."""

    req: TraceRequest
    submitted_at: float
    deadline_at: Optional[float]
    status: str = "queued"          # queued | running | done
    partition: Optional[int] = None
    engine_rid: Optional[str] = None
    migrations: int = 0
    tokens: List[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finish_reason: Optional[str] = None
    finished_at: Optional[float] = None


class FleetRouter:
    """Partition router + migration engine + fleet metrics aggregator.

    ``engine_factory(pid)`` builds one
    :class:`~elephas_tpu_torch.serving.engine.ServingEngine` per partition; the
    factory MUST wire the router's ``clock`` into every engine it builds
    (lifecycle ``clock=`` and, for deterministic replay, ``perf_clock=``)
    — the router shares that clock with its registry and policy.
    """

    def __init__(self, engine_factory: Callable[[int], Any],
                 n_partitions: int = 2, *,
                 policy: Optional[FleetPolicy] = None,
                 registry: Optional[HeartbeatRegistry] = None,
                 clock: Callable[[], float] = None,
                 lease_s: float = 3.0):
        if n_partitions < 1:
            raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
        if clock is None:
            import time
            clock = time.monotonic
        self._factory = engine_factory
        self._clock = clock
        self.policy = policy or FleetPolicy()
        self.registry = registry or HeartbeatRegistry(
            lease_s=lease_s, clock=clock)
        self._engines: Dict[int, Any] = {}
        self._states: Dict[str, _ReqState] = {}
        self._next_pid = 0
        self._seen_epoch = self.registry.epoch
        self._latest_params = None      # (params, version) for late joiners
        # fleet counters
        self.migrations = 0
        self.epoch_changes = 0
        self._ttft: List[float] = []
        self._itl: List[float] = []
        for _ in range(n_partitions):
            self.join_partition()
        # the bootstrap joins are not a membership CHANGE to react to
        self._seen_epoch = self.registry.epoch

    # -- membership -------------------------------------------------------
    @staticmethod
    def member_id(pid: int) -> str:
        return f"serve-{pid}"

    def partition_ids(self) -> List[int]:
        return sorted(self._engines)

    @property
    def n_live(self) -> int:
        return len(self._engines)

    def join_partition(self) -> int:
        """Add one partition: build its engine, grant its lease, apply
        the latest published weights (a late joiner must not serve stale
        params). Returns the new partition id."""
        pid = self._next_pid
        self._next_pid += 1
        eng = self._factory(pid)
        if self._latest_params is not None:
            params, version = self._latest_params
            eng.swap_params(params, version)
        self._engines[pid] = eng
        self.registry.join(self.member_id(pid))
        return pid

    def kill_partition(self, pid: int) -> None:
        """Simulate a partition CRASH: the engine object is dropped and
        its lease simply stops renewing. Requests stranded on it migrate
        when the sweep expires the lease and the epoch changes — the
        crash is detected by silence, not by an announcement, which is
        the failure mode a real fleet sees."""
        if pid not in self._engines:
            raise KeyError(f"unknown partition {pid}")
        del self._engines[pid]

    def retire_partition(self, pid: int) -> None:
        """Graceful shrink: surrender the lease (``leave``), cancel the
        partition's in-flight requests, and requeue them front-of-line
        for immediate re-dispatch elsewhere — no work is lost and no
        lease timeout is waited out."""
        if pid not in self._engines:
            raise KeyError(f"unknown partition {pid}")
        eng = self._engines.pop(pid)
        self.registry.leave(self.member_id(pid))
        for state in self._states.values():
            if state.status == "running" and state.partition == pid:
                eng.cancel(state.engine_rid)
                eng.result(state.engine_rid)  # discard the cancel record
                self._requeue(state)

    def _live_pids(self) -> List[int]:
        live = set(self.registry.live())
        return [pid for pid in sorted(self._engines)
                if self.member_id(pid) in live]

    # -- migration --------------------------------------------------------
    def _requeue(self, state: _ReqState) -> None:
        state.status = "queued"
        state.partition = None
        state.engine_rid = None
        state.migrations += 1
        self.migrations += 1
        self.policy.push_front(state.req)

    def _rebalance(self) -> None:
        """Membership epoch changed: requeue every request whose
        partition is no longer live. Tokens already streamed stay —
        re-dispatch resumes from ``prompt ++ generated`` under the
        original seed, so the continuation is bitwise identical."""
        live = set(self._live_pids())
        for state in self._states.values():
            if state.status == "running" and state.partition not in live:
                self._requeue(state)

    # -- intake -----------------------------------------------------------
    def submit(self, req: TraceRequest) -> Optional[str]:
        """Offer one request to the fleet. Returns ``None`` on enqueue or
        the shed reason if the policy refused it (terminal — recorded)."""
        now = self._clock()
        if req.request_id in self._states:
            raise AdmissionError("bad_request",
                                 f"duplicate request_id {req.request_id!r}")
        state = _ReqState(
            req=req, submitted_at=now,
            deadline_at=(None if req.deadline_s is None
                         else req.arrival_s + req.deadline_s))
        self._states[req.request_id] = state
        reason = self.policy.submit(req, now)
        if reason is not None:
            state.status = "done"
            state.finish_reason = reason
            state.finished_at = now
        return reason

    # -- dispatch ---------------------------------------------------------
    def _pick_partition(self) -> Optional[int]:
        """Least-loaded live partition with a free slot AND an empty
        engine queue (the fleet queue is the only real queue)."""
        best, best_key = None, None
        for pid in self._live_pids():
            eng = self._engines[pid]
            if eng.kv.free_slots < 1 or eng.scheduler.queue_depth > 0:
                continue
            key = (-eng.kv.free_slots, len(eng._slot_req), pid)
            if best_key is None or key < best_key:
                best, best_key = pid, key
        return best

    def _engine_adapter(self, eng, tenant: int) -> int:
        """Map the fleet tenant id onto the partition's LoRA adapters:
        pass it through when the engine actually serves that adapter
        (paged multi-tenant model), else serve on the base weights —
        tenant accounting stays fleet-level either way."""
        if not getattr(eng, "_paged", False):
            return 0
        n_adapters = int(getattr(getattr(eng, "model", None),
                                 "n_adapters", 1) or 1)
        return tenant if 0 <= tenant < n_adapters else 0

    def _make_on_token(self, state: _ReqState) -> Callable:
        def on_token(_rid: str, token: int, _done: bool) -> None:
            now = self._clock()
            state.tokens.append(int(token))
            if state.first_token_at is None:
                state.first_token_at = now
                self._ttft.append(now - state.submitted_at)
            else:
                self._itl.append(now - state.last_token_at)
            state.last_token_at = now
        return on_token

    def _dispatch(self, kind: str, req: TraceRequest) -> bool:
        """Place one policy decision. Returns False when no partition can
        take the request right now (request goes back front-of-line)."""
        now = self._clock()
        state = self._states[req.request_id]
        if kind == "shed":
            state.status = "done"
            state.finish_reason = "shed"
            state.finished_at = now
            return True
        pid = self._pick_partition()
        if pid is None:
            self.policy.push_front(req)
            return False
        eng = self._engines[pid]
        # resume semantics: a migrated request re-prefills its prompt
        # PLUS everything it already streamed, keeps its seed, and only
        # asks for the REMAINING budget — (seed, position) keys make the
        # continuation bitwise identical to the uninterrupted stream
        prompt = list(req.prompt) + state.tokens
        remaining = req.max_new - len(state.tokens)
        if remaining < 1:
            state.status = "done"
            state.finish_reason = "length"
            state.finished_at = now
            return True
        engine_rid = f"{req.request_id}@m{state.migrations}"
        deadline_s = (None if state.deadline_at is None
                      else state.deadline_at - now)
        try:
            eng.submit(
                np.asarray(prompt, np.int32), remaining,
                temperature=req.temperature, eos_id=req.eos_id,
                priority=req.priority, seed=req.seed,
                on_token=self._make_on_token(state),
                request_id=engine_rid, deadline_s=deadline_s,
                adapter_id=self._engine_adapter(eng, req.tenant))
        except AdmissionError:
            self.policy.push_front(req)
            return False
        state.status = "running"
        state.partition = pid
        state.engine_rid = engine_rid
        return True

    # -- the control loop -------------------------------------------------
    def step(self) -> Dict[str, int]:
        """One fleet control iteration: renew leases, sweep the dead,
        rebalance on epoch change, drain the policy into free capacity,
        step every live engine once, and collect finished requests.
        Returns a small counter dict for driver-loop introspection."""
        for pid in self._engines:
            self.registry.heartbeat(self.member_id(pid))
        self.registry.sweep()
        epoch = self.registry.epoch
        if epoch != self._seen_epoch:
            self._seen_epoch = epoch
            self.epoch_changes += 1
            self._rebalance()
        dispatched = 0
        while True:
            decision = self.policy.poll(self._clock())
            if decision is None:
                break
            if not self._dispatch(*decision):
                break
            dispatched += 1
        stepped = 0
        for pid in self._live_pids():
            eng = self._engines[pid]
            if eng.scheduler.queue_depth or eng.kv.active_slots:
                eng.step()
                stepped += 1
        collected = self._collect_finished()
        return {"dispatched": dispatched, "stepped": stepped,
                "collected": collected}

    def _collect_finished(self) -> int:
        now = self._clock()
        done = 0
        for state in self._states.values():
            if state.status != "running":
                continue
            eng = self._engines.get(state.partition)
            if eng is None:
                continue  # partition died; rebalance will requeue
            rec = eng.result(state.engine_rid)
            if rec is None:
                continue
            if rec.finish_reason == "shed":
                # the partition refused late — give the fleet queue one
                # more chance to place or shed it with fleet-level state
                self._requeue(state)
                continue
            state.status = "done"
            state.finish_reason = rec.finish_reason
            state.finished_at = now
            done += 1
        return done

    @property
    def active(self) -> int:
        """Requests the fleet still owes an answer for."""
        return sum(1 for s in self._states.values() if s.status != "done")

    # -- weight rollover --------------------------------------------------
    def swap_params(self, params, version: Optional[int] = None) -> int:
        """Fan a hot weight swap out to every live partition (between
        steps, so each engine's round-boundary attribution contract
        holds fleet-wide) and remember it for partitions that join
        later. Returns the version stamp applied."""
        v = version
        for pid in self._live_pids():
            v = self._engines[pid].swap_params(params, version)
        if v is None:
            v = 0
        self._latest_params = (params, v)
        return v

    # -- observability ----------------------------------------------------
    def results(self) -> Dict[str, _ReqState]:
        """All terminal request states by id (tokens, reason, timing)."""
        return {rid: s for rid, s in self._states.items()
                if s.status == "done"}

    def snapshot(self) -> Dict[str, Any]:
        """Fleet-level JSON-able metrics: membership, latency
        percentiles, SLO attainment vs offered load, per-tenant
        accounting with live DRR credit, per-partition engine stats."""
        states = list(self._states.values())
        done = [s for s in states if s.status == "done"]
        ok = [s for s in done if s.finish_reason in OK_REASONS]
        with_deadline = [s for s in states if s.deadline_at is not None]
        wd_done = [s for s in with_deadline if s.status == "done"]
        met = [s for s in wd_done
               if s.finish_reason in OK_REASONS
               and s.finished_at is not None
               and s.finished_at <= s.deadline_at]
        span = max((s.submitted_at for s in states), default=0.0) - min(
            (s.submitted_at for s in states), default=0.0)
        tenants: Dict[str, Any] = {}
        for s in states:
            row = tenants.setdefault(str(s.req.tenant), {
                "submitted": 0, "done": 0, "ok": 0, "shed": 0, "tokens": 0})
            row["submitted"] += 1
            row["tokens"] += len(s.tokens)
            if s.status == "done":
                row["done"] += 1
                if s.finish_reason in OK_REASONS:
                    row["ok"] += 1
                elif s.finish_reason in ("shed", "overload"):
                    row["shed"] += 1
        policy_snap = self.policy.snapshot()
        for tid, prow in policy_snap["tenants"].items():
            tenants.setdefault(tid, {}).update(
                deficit=prow["deficit"], tier=prow["tier"],
                rate_tokens=prow["rate_tokens"])
        return {
            "fleet": {
                "epoch": self.registry.epoch,
                "epoch_changes": self.epoch_changes,
                "partitions_live": self._live_pids(),
                "queued": self.policy.queue_depth,
                "running": sum(1 for s in states if s.status == "running"),
                "done": len(done),
                "ok": len(ok),
                "migrations": self.migrations,
            },
            "latency": {
                "ttft_p50": _percentile(self._ttft, 50),
                "ttft_p99": _percentile(self._ttft, 99),
                "itl_p50": _percentile(self._itl, 50),
                "itl_p99": _percentile(self._itl, 99),
                "n_ttft": len(self._ttft),
                "n_itl": len(self._itl),
            },
            "slo": {
                "offered": len(states),
                "offered_rps": (len(states) / span if span > 0
                                else float(len(states))),
                "with_deadline": len(with_deadline),
                "deadline_done": len(wd_done),
                "deadline_met": len(met),
                "deadline_missed": len(wd_done) - len(met),
                "attainment": (len(met) / len(wd_done) if wd_done
                               else None),
            },
            "tenants": tenants,
            "partitions": {
                str(pid): self._engines[pid].snapshot()
                for pid in sorted(self._engines)
            },
        }


def router_sink(router: FleetRouter, template: Dict[str, Any]):
    """Adapt a :class:`FleetRouter` into a
    :class:`~elephas_tpu_torch.streaming.publisher.WeightPublisher` sink: each
    published wire-order weight list is bridged through ``template`` and
    hot-swapped across EVERY live partition (late joiners pick it up at
    join). The fleet-wide analogue of
    :func:`~elephas_tpu_torch.streaming.publisher.engine_sink`."""
    from ..streaming.bridge import list_to_params

    def sink(weights, version: int) -> None:
        router.swap_params(list_to_params(weights, template), version)

    return sink


def run_trace(router: FleetRouter, trace: Trace, *, clock,
              step_dt: float = 0.05, autoscaler=None,
              chaos: Optional[List[Dict[str, Any]]] = None,
              max_steps: int = 200_000) -> Dict[str, Any]:
    """Replay a :class:`~elephas_tpu_torch.fleet.traffic.Trace` through the
    fleet on an explicitly-advanced ``clock`` (a
    :class:`~elephas_tpu_torch.fleet.traffic.SimClock` the router, registry,
    policy, and every engine ALL read).

    ``chaos`` is a list of ``{"t": float, "op": "kill"|"join"|"retire",
    "pid": int}`` events applied when the clock passes ``t`` (``pid``
    ignored for ``join``) — the pinned chaos scenario is exactly such a
    schedule. ``autoscaler.maybe_scale(now)`` is polled every iteration
    when given. Runs until every submitted request is terminal, then
    returns the final fleet snapshot."""
    pending = sorted(trace.requests, key=lambda r: (r.arrival_s,
                                                    r.request_id))
    events = sorted(chaos or [], key=lambda e: e["t"])
    i = e = steps = 0
    while True:
        now = clock()
        while e < len(events) and events[e]["t"] <= now:
            ev = events[e]
            e += 1
            if ev["op"] == "kill":
                router.kill_partition(ev["pid"])
            elif ev["op"] == "retire":
                router.retire_partition(ev["pid"])
            elif ev["op"] == "join":
                router.join_partition()
            else:
                raise ValueError(f"unknown chaos op {ev['op']!r}")
        while i < len(pending) and pending[i].arrival_s <= now:
            router.submit(pending[i])
            i += 1
        if autoscaler is not None:
            autoscaler.maybe_scale(now)
        router.step()
        if i >= len(pending) and e >= len(events) and router.active == 0:
            break
        steps += 1
        if steps >= max_steps:
            raise RuntimeError(
                f"run_trace exceeded max_steps={max_steps} "
                f"(active={router.active}, submitted={i}/{len(pending)})")
        clock.advance(step_dt)
    snap = router.snapshot()
    snap["replay"] = {"steps": steps, "wall_s": round(clock(), 6)}
    return snap
