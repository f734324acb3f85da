"""Elastic membership: heartbeat leases, quorum rounds, straggler backups.

DeepSpark (arxiv 1602.08191) identifies the two cost-dominant failure modes
of synchronous data parallelism on commodity clusters: the whole round blocks
on the slowest worker, and a single lost worker stalls it forever. Its answer
is *partial* aggregation — commit a round once K of N workers report, reject
what arrives late. This module is that layer for the host training paths:

- :class:`HeartbeatRegistry` — per-worker leases with deadline-based
  liveness and a **monotonic membership epoch**. Every join/expire bumps the
  epoch; work launched under an older epoch than a member's fence is stale
  by definition and its result is rejected. The clock is injectable (and in
  chaos tests driven off the seeded :class:`~elephas_tpu_torch.resilience.faults.
  FaultPlan` scheduling), so liveness decisions replay deterministically.
- :class:`QuorumRunner` — runs one round of partition tasks with
  K-of-N commit semantics: the round commits when every live member has
  reported, or when the round deadline passes with at least ``quorum``
  results in hand. Stragglers flagged by the registry get a **backup clone**
  of their task (same task id, next attempt number); first finish wins, and
  the parameter-server attempt machinery (``register_attempt`` rollback +
  server-side attempt fences) keeps the loser's deltas from double-applying.

Observability: the registry keeps a bounded event log (join / heartbeat
expiry / epoch bumps / backups / failovers / per-round shortfall) and
exposes it as a JSON-able :meth:`HeartbeatRegistry.snapshot`, same style as
``serving/metrics.py``.

A copy of ``elephas_tpu/resilience/membership.py`` (standard library
only) over the port's :class:`~elephas_tpu_torch.data.rdd.TaskContext`.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


class QuorumLostError(RuntimeError):
    """Fewer live workers than the quorum requires: the round cannot commit."""


@dataclass
class MembershipEvent:
    """One membership transition, stamped with the registry clock + epoch."""

    kind: str            # join | expire | leave | rejoin | backup | failover
                         # | late_reject | round
    member: Optional[str]
    epoch: int
    at: float
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "member": self.member,
            "epoch": self.epoch,
            "at": round(float(self.at), 6),
            **({"detail": self.detail} if self.detail else {}),
        }


class HeartbeatRegistry:
    """Lease-based group membership with monotonic epochs.

    Every member holds a lease of ``lease_s`` seconds, renewed by
    :meth:`heartbeat`. :meth:`sweep` expires members whose lease lapsed —
    each expiry (and each join) bumps the monotonic membership ``epoch``.
    A member older than ``straggler_after_s`` since its last beat (but still
    inside its lease) is flagged a *straggler*: alive, but slow enough that a
    backup task is worth launching.

    Late-result fencing: :meth:`fence` records, per member, the epoch below
    which results are stale. Work launched before a member was expired (or
    re-joined) carries the old epoch; comparing launch epoch against the
    fence rejects it without any wall-clock reasoning.

    Thread-safe; the clock is injectable so chaos tests can drive liveness
    deterministically off a fake clock instead of real sleeps.
    """

    def __init__(self, *, lease_s: float = 10.0,
                 straggler_after_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_event: Optional[Callable[[MembershipEvent], None]] = None,
                 max_events: int = 256, max_rounds: int = 64):
        if lease_s <= 0:
            raise ValueError("lease_s must be > 0")
        if straggler_after_s is not None and straggler_after_s <= 0:
            raise ValueError("straggler_after_s must be > 0")
        self.lease_s = float(lease_s)
        self.straggler_after_s = (
            None if straggler_after_s is None else float(straggler_after_s)
        )
        self.clock = clock
        self.on_event = on_event
        self._lock = threading.Lock()
        self._epoch = 0
        self._last_beat: Dict[str, float] = {}
        self._fences: Dict[str, int] = {}
        self._events: deque = deque(maxlen=int(max_events))
        self._rounds: deque = deque(maxlen=int(max_rounds))
        self._counts: Counter = Counter()
        self._failovers = 0

    # -- membership transitions ------------------------------------------
    def _emit(self, kind: str, member: Optional[str],
              **detail: Any) -> MembershipEvent:
        # caller holds the lock
        ev = MembershipEvent(kind=kind, member=member, epoch=self._epoch,
                             at=self.clock(), detail=dict(detail))
        self._events.append(ev)
        self._counts[kind] += 1
        if self.on_event is not None:
            self.on_event(ev)
        return ev

    def join(self, member: str) -> int:
        """Admit (or re-admit) ``member``; returns the new epoch."""
        with self._lock:
            rejoin = member in self._fences and member not in self._last_beat
            self._last_beat[member] = self.clock()
            self._epoch += 1
            if rejoin:
                # results launched before the member died are still stale:
                # keep the fence at the rejoin epoch
                self._fences[member] = self._epoch
            self._emit("rejoin" if rejoin else "join", member)
            return self._epoch

    def heartbeat(self, member: str) -> None:
        """Renew ``member``'s lease (implicitly joining unknown members)."""
        with self._lock:
            if member not in self._last_beat:
                self._epoch += 1
                self._emit("join", member, implicit=True)
            self._last_beat[member] = self.clock()

    def leave(self, member: str) -> None:
        """Graceful departure: bump the epoch, fence the member's results."""
        with self._lock:
            if self._last_beat.pop(member, None) is None:
                return
            self._epoch += 1
            self._fences[member] = self._epoch
            self._emit("leave", member)

    def expire(self, member: str) -> None:
        """Force-expire ``member`` (e.g. the driver declared it dead after
        exhausted retries) — same epoch/fence semantics as a lease lapse."""
        with self._lock:
            if self._last_beat.pop(member, None) is None:
                return
            self._epoch += 1
            self._fences[member] = self._epoch
            self._emit("expire", member, forced=True)

    def sweep(self) -> List[str]:
        """Expire every member whose lease lapsed; returns who was expired."""
        now = self.clock()
        expired = []
        with self._lock:
            for member, beat in list(self._last_beat.items()):
                if now - beat >= self.lease_s:
                    del self._last_beat[member]
                    self._epoch += 1
                    self._fences[member] = self._epoch
                    self._emit("expire", member,
                               lease_age=round(now - beat, 6))
                    expired.append(member)
        return expired

    # -- queries ---------------------------------------------------------
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def fence(self, member: str) -> int:
        """Results from work launched at an epoch < fence are stale."""
        with self._lock:
            return self._fences.get(member, 0)

    def is_live(self, member: str, default: bool = False) -> bool:
        """Live = holds an unexpired lease. ``default`` answers for members
        the registry has never seen (external callers may treat unknown as
        live when membership is opt-in)."""
        with self._lock:
            beat = self._last_beat.get(member)
            if beat is None:
                return default and member not in self._fences
            return self.clock() - beat < self.lease_s

    def live(self) -> List[str]:
        now = self.clock()
        with self._lock:
            return sorted(
                m for m, beat in self._last_beat.items()
                if now - beat < self.lease_s
            )

    def stragglers(self) -> List[str]:
        """Members inside their lease but silent past ``straggler_after_s``."""
        if self.straggler_after_s is None:
            return []
        now = self.clock()
        with self._lock:
            return sorted(
                m for m, beat in self._last_beat.items()
                if self.straggler_after_s <= now - beat < self.lease_s
            )

    # -- observability ----------------------------------------------------
    def observe_backup(self, member: str, attempt: int) -> None:
        with self._lock:
            self._emit("backup", member, attempt=int(attempt))

    def observe_failover(self, *, endpoint: int,
                         version: Optional[int] = None) -> None:
        with self._lock:
            self._failovers += 1
            self._emit("failover", None, endpoint=int(endpoint),
                       **({} if version is None else {"version": int(version)}))

    def observe_late_reject(self, member: str, *, launch_epoch: int) -> None:
        with self._lock:
            self._emit("late_reject", member, launch_epoch=int(launch_epoch))

    def observe_round(self, *, expected: int, received: int,
                      quorum: Optional[int] = None,
                      backups: int = 0, deadline_hit: bool = False) -> None:
        """Record one aggregation round's outcome (shortfall = how many
        expected results the commit went ahead without)."""
        with self._lock:
            entry = {
                "epoch": self._epoch,
                "expected": int(expected),
                "received": int(received),
                "shortfall": max(0, int(expected) - int(received)),
                "quorum": quorum if quorum is None else int(quorum),
                "backups": int(backups),
                "deadline_hit": bool(deadline_hit),
            }
            self._rounds.append(entry)
            self._emit("round", None, **entry)

    @property
    def failovers(self) -> int:
        with self._lock:
            return self._failovers

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able registry state, ``serving/metrics.py`` style."""
        now = self.clock()
        with self._lock:
            live = sorted(
                m for m, beat in self._last_beat.items()
                if now - beat < self.lease_s
            )
            return {
                "membership": {
                    "epoch": self._epoch,
                    "live": live,
                    "stragglers": sorted(
                        m for m, beat in self._last_beat.items()
                        if self.straggler_after_s is not None
                        and self.straggler_after_s <= now - beat < self.lease_s
                    ),
                    "fences": dict(self._fences),
                    "lease_s": self.lease_s,
                    "straggler_after_s": self.straggler_after_s,
                },
                "counters": {
                    **dict(self._counts),
                    "failovers": self._failovers,
                },
                "rounds": list(self._rounds),
                "events": [e.to_dict() for e in self._events],
            }


def member_id_for(partition: int) -> str:
    """Registry member id for a partition index (one worker per partition on
    the facade's thread-pool executor)."""
    return f"partition-{partition}"


class QuorumRunner:
    """One K-of-N round over partitions, with straggler backups.

    Replaces ``rdd.mapPartitions(...).collect()`` for elastic synchronous
    training: each partition's task runs on its own thread under a
    :class:`~elephas_tpu_torch.data.rdd.TaskContext` (partition id, attempt
    number, stage id — identical to the facade RDD's contract, so workers
    and the ``FaultPlan`` can't tell the difference). The round:

    - commits as soon as every *live* member has reported;
    - commits the received subset once the round deadline passes with at
      least ``quorum`` results (DeepSpark partial aggregation);
    - relaunches crashed tasks up to ``max_failures`` attempts, then
      expires the member (permanent node loss);
    - launches a backup clone when the registry flags a straggler; first
      finish wins, the loser is rejected (per-partition, only one result
      commits) and its server-side deltas are fenced by attempt number;
    - rejects results whose launch epoch is below the member's fence
      (late deltas from expired members).

    Raises :class:`QuorumLostError` when fewer than ``quorum`` members can
    still possibly report.
    """

    def __init__(self, registry: HeartbeatRegistry, *,
                 quorum: Optional[int] = None,
                 round_deadline_s: Optional[float] = None,
                 backup_stragglers: bool = True,
                 max_failures: int = 4,
                 poll_s: float = 0.02):
        self.registry = registry
        self.quorum = quorum
        self.round_deadline_s = round_deadline_s
        self.backup_stragglers = bool(backup_stragglers)
        self.max_failures = int(max_failures)
        self.poll_s = float(poll_s)
        self.backups_launched = 0
        self.abandoned: List[int] = []   # pids uncommitted at quorum commit

    def run(self, partitions: Sequence[Sequence[Any]],
            task_fn: Callable[[Iterator[Any]], Iterator[Any]],
            *, stage_id: int = 0) -> Dict[int, List[Any]]:
        """Run ``task_fn`` over every partition; return {pid: results} for
        the committed subset (every value is the task's materialized output
        list, exactly what ``mapPartitions`` would have collected)."""
        from ..data.rdd import TaskContext

        n = len(partitions)
        if n == 0:
            return {}
        quorum = n if self.quorum is None else min(int(self.quorum), n)
        if quorum < 1:
            raise ValueError("quorum must be >= 1")
        registry = self.registry
        clock = registry.clock
        for pid in range(n):
            registry.join(member_id_for(pid))

        results: "queue.Queue" = queue.Queue()
        committed: Dict[int, List[Any]] = {}
        attempts = {pid: 0 for pid in range(n)}        # next attempt number
        failures = {pid: 0 for pid in range(n)}
        outstanding = {pid: 0 for pid in range(n)}     # in-flight attempts
        backed_up = set()
        dead = set()

        def _attempt(pid: int, attempt: int, launch_epoch: int) -> None:
            outer = TaskContext.get()
            TaskContext._set(TaskContext(pid, attempt, stage_id))
            member = member_id_for(pid)
            registry.heartbeat(member)
            try:
                out = list(task_fn(iter(partitions[pid])))
            except BaseException as err:  # noqa: BLE001 - reported to driver
                results.put((pid, attempt, launch_epoch, err, None))
            else:
                registry.heartbeat(member)
                results.put((pid, attempt, launch_epoch, None, out))
            finally:
                TaskContext._set(outer)

        executor = ThreadPoolExecutor(max_workers=max(2, 2 * n))

        def _launch(pid: int) -> None:
            attempt = attempts[pid]
            attempts[pid] = attempt + 1
            outstanding[pid] += 1
            executor.submit(_attempt, pid, attempt, registry.epoch)

        try:
            for pid in range(n):
                _launch(pid)
            deadline = (
                None if self.round_deadline_s is None
                else clock() + float(self.round_deadline_s)
            )
            while True:
                pending = [
                    pid for pid in range(n)
                    if pid not in committed and pid not in dead
                ]
                if not pending:
                    break
                if len(committed) + len(pending) < quorum:
                    raise QuorumLostError(
                        f"only {len(committed)} of {n} partitions can still "
                        f"report (quorum {quorum}); "
                        f"dead={sorted(dead)}"
                    )
                if (deadline is not None and clock() >= deadline
                        and len(committed) >= quorum):
                    # DeepSpark partial aggregation: the round goes ahead
                    # with the received subset; whoever is still running is
                    # expired so their eventual result (and, on the async
                    # path, their uncommitted server deltas) is fenced out.
                    for pid in pending:
                        registry.expire(member_id_for(pid))
                        self.abandoned.append(pid)
                    break
                if self.backup_stragglers:
                    for member in registry.stragglers():
                        pid = int(member.rsplit("-", 1)[1])
                        if (pid in committed or pid in dead
                                or pid in backed_up):
                            continue
                        backed_up.add(pid)
                        self.backups_launched += 1
                        registry.observe_backup(member, attempts[pid])
                        _launch(pid)
                try:
                    pid, attempt, launch_epoch, err, out = results.get(
                        timeout=self.poll_s
                    )
                except queue.Empty:
                    # Lease lapse == node loss: the member is fenced (its
                    # late result will be rejected) and its partition is
                    # written off for this round. lease_s must therefore
                    # exceed the expected task duration unless the worker
                    # heartbeats mid-task.
                    for member in registry.sweep():
                        pid = int(member.rsplit("-", 1)[1])
                        if pid not in committed:
                            dead.add(pid)
                    continue
                outstanding[pid] -= 1
                member = member_id_for(pid)
                if pid in committed or pid in dead:
                    # first-finish already won (or the member was declared
                    # dead): the loser's result must not double-commit.
                    registry.observe_late_reject(
                        member, launch_epoch=launch_epoch
                    )
                    continue
                if launch_epoch < registry.fence(member):
                    # launched before the member was expired/rejoined: stale
                    # by membership epoch, reject it.
                    registry.observe_late_reject(
                        member, launch_epoch=launch_epoch
                    )
                    continue
                if err is None:
                    committed[pid] = out
                    continue
                failures[pid] += 1
                if failures[pid] >= self.max_failures:
                    if outstanding[pid] == 0:
                        dead.add(pid)
                        registry.expire(member)
                elif outstanding[pid] == 0:
                    _launch(pid)
            received = len(committed)
            if received < quorum:
                raise QuorumLostError(
                    f"round ended with {received} of {n} partitions "
                    f"(quorum {quorum})"
                )
            registry.observe_round(
                expected=n, received=received, quorum=quorum,
                backups=self.backups_launched,
                deadline_hit=bool(self.abandoned),
            )
            return committed
        finally:
            # Never block the driver on abandoned attempts: zombie threads
            # finish on their own and their queued results are simply never
            # read. (Their server-side pushes are fenced separately.)
            executor.shutdown(wait=False)
