"""Seeded, deterministic fault injection.

Every fault decision is a pure function of ``(seed, site, per-site call
index)`` via a keyed hash — NOT a shared RNG stream — so concurrent workers
cannot reorder each other's faults: whatever thread interleaving happens,
the Nth push on a given site sees the same verdict on every run. That is
what turns chaos scenarios into pinnable tests (``tests/resilience/``)
instead of flakes.

Injection points, one per layer the tentpole names:

- **parameter clients** — :class:`FaultyClient` wraps any
  :class:`~elephas_tpu_torch.parameter.client.BaseParameterClient`: pushes can be
  dropped (delta lost in the network, at-most-once), duplicated
  (retransmit, at-least-once), or fail with a :class:`TransientFault`
  (a ``ConnectionError``, so retry policies treat it as real); pulls can be
  delayed or fail transiently; and a worker can be killed after its Nth
  push (``crash_partition``/``crash_after_pushes``) — the async
  "crash mid-partition" that exercises the server's attempt rollback.
- **worker partitions** — :meth:`FaultPlan.maybe_crash_partition` kills a
  synchronous worker mid-partition (work done, result lost), once, on
  attempt 0, driving the facade's Spark-parity task retry.
- **compiled fit chunks** — :meth:`FaultPlan.tick` raises at a configured
  per-site call index (e.g. ``{"fit_chunk": 2}`` kills the 3rd epoch chunk
  of a checkpointed ``_fit_jax``), once — the whole-fit death the
  :class:`~elephas_tpu_torch.resilience.supervisor.TrainingSupervisor` recovers
  from.
- **parameter servers** — :meth:`FaultPlan.drop_server_push` /
  :meth:`FaultPlan.delay_server_pull`, consulted by
  ``BaseParameterServer`` when constructed with ``fault_plan=``.
- **serving steps** — :meth:`FaultPlan.serving_stall` injects deterministic
  wall-clock stalls by engine step index; the ``ServingEngine`` adds them
  to its clock reading, pushing slow requests past their deadlines.
- **host processes** — :meth:`FaultPlan.host_kill` /
  :meth:`FaultPlan.host_partition` / :meth:`FaultPlan.join_delay` drive the
  elastic control plane (``parallel/elastic.py``): a real ``SIGKILL`` of a
  host process mid-round, a one-sided heartbeat-channel partition (the
  zombie keeps computing; its delta must be fenced), and a deferred
  admission of a freshly spawned host (late join). All exact round→host
  maps, so membership-event traces pin at fixed seed.
- **the wire itself** — :meth:`FaultPlan.wrap_socket` returns a
  :class:`FaultySocket` shim that mutates outbound FRAMES (never 1-byte
  opcodes/acks or the 5-byte negotiation hello, so every injected
  corruption lands in checksummed frame bytes): ``wire_flip_bits`` XORs
  one deterministic bit, ``wire_garbage`` overwrites the frame head with
  junk, ``wire_truncate`` sends a prefix then closes, ``wire_duplicate``
  sends the frame twice, and ``wire_stall_s``/``wire_stall_prob`` sleep
  mid-frame (the slow-loris). Per-frame verdicts are seeded and
  per-opportunity like every other site; fires are counted in ``fired``
  and every typed catch the stack reports lands in ``wire_caught`` — the
  soak's "corruption is caught, never applied" ledger.

Faults fire AT MOST ONCE per crash site (``fired``/``crash_fired``
bookkeeping), so retries and supervisor restarts proceed — the injected
failure is a crash, not a curse.

A copy of ``elephas_tpu/resilience/faults.py`` over the port's
:class:`~elephas_tpu_torch.parameter.client.BaseParameterClient` and
:class:`~elephas_tpu_torch.data.rdd.TaskContext`: for the same seed every
fire schedule is the reference's (the same sites, the same opportunities).
"""

from __future__ import annotations

import hashlib
import socket as socket_mod
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

from ..parameter.client import BaseParameterClient


class InjectedFault(Exception):
    """Base class for every injected failure (mixed into concrete types so
    ``except InjectedFault`` can tell chaos from genuine breakage)."""


class TransientFault(ConnectionError, InjectedFault):
    """An injected transient network error. Subclasses ``ConnectionError``
    so retry policies and generic handlers treat it like the real thing."""


class InjectedWorkerCrash(RuntimeError, InjectedFault):
    """An injected worker/partition death (task retry should absorb it)."""


def _unit(seed: int, site: str, n: int) -> float:
    """Deterministic uniform draw in [0, 1) keyed by (seed, site, n)."""
    digest = hashlib.blake2b(
        f"{seed}:{site}:{n}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2.0**64


class FaultPlan:
    """One seeded plan of everything that will go wrong.

    Rates are probabilities per opportunity; crash sites are exact call
    indices. All counters are thread-safe, and every decision depends only
    on the plan's seed and the per-site opportunity index, never on global
    RNG state or other sites' traffic.
    """

    def __init__(self, seed: int = 0, *,
                 drop_push: float = 0.0,
                 dup_push: float = 0.0,
                 push_error_rate: float = 0.0,
                 pull_error_rate: float = 0.0,
                 pull_delay_s: float = 0.0,
                 pull_delay_prob: float = 0.0,
                 crash_partition: Optional[int] = None,
                 crash_after_pushes: int = 0,
                 crash_sites: Optional[Dict[str, int]] = None,
                 dead_partitions: Optional[Iterable[int]] = None,
                 straggler_stalls: Optional[Dict[int, float]] = None,
                 server_drop_push: float = 0.0,
                 server_pull_delay_s: float = 0.0,
                 serving_stalls: Optional[Dict[int, float]] = None,
                 kill_hosts: Optional[Dict[int, int]] = None,
                 partition_hosts: Optional[Dict[int, int]] = None,
                 join_delay_rounds: Optional[Dict[int, int]] = None,
                 wire_flip_bits: float = 0.0,
                 wire_truncate: float = 0.0,
                 wire_garbage: float = 0.0,
                 wire_duplicate: float = 0.0,
                 wire_stall_s: float = 0.0,
                 wire_stall_prob: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.seed = int(seed)
        self.drop_push = float(drop_push)
        self.dup_push = float(dup_push)
        self.push_error_rate = float(push_error_rate)
        self.pull_error_rate = float(pull_error_rate)
        self.pull_delay_s = float(pull_delay_s)
        self.pull_delay_prob = float(pull_delay_prob)
        self.crash_partition = crash_partition
        self.crash_after_pushes = int(crash_after_pushes)
        self.crash_sites = dict(crash_sites or {})
        # Partitions that die on EVERY attempt (machine gone, not task flake):
        # the elastic-quorum scenario — retries are futile and the membership
        # layer must expire these members and commit without them.
        self.dead_partitions = frozenset(
            int(p) for p in (dead_partitions or ())
        )
        # Deterministic straggler injection: partition -> seconds stalled at
        # the start of attempt 0 (backup attempts run at full speed, so
        # first-finish-wins has a winner).
        self.straggler_stalls = {
            int(p): float(s) for p, s in (straggler_stalls or {}).items()
        }
        self.server_drop_push = float(server_drop_push)
        self.server_pull_delay_s = float(server_pull_delay_s)
        self.serving_stalls = dict(serving_stalls or {})
        # Host-level crash sites for the elastic control plane
        # (parallel/elastic.py) — exact round→host maps, like crash_sites:
        # kill_hosts SIGKILLs a host PROCESS mid-round; partition_hosts cuts
        # a host's heartbeat channel (the worker stays alive and keeps
        # computing — a zombie whose delta must be fenced); join_delay_rounds
        # is host→rounds a spawned host's admission is deferred (late join).
        self.kill_hosts = {
            int(r): int(h) for r, h in (kill_hosts or {}).items()
        }
        self.partition_hosts = {
            int(r): int(h) for r, h in (partition_hosts or {}).items()
        }
        self.join_delay_rounds = {
            int(h): int(d) for h, d in (join_delay_rounds or {}).items()
        }
        # Wire-level sites (per outbound frame, through wrap_socket's shim).
        # Rates are per-frame probabilities; wire_stall_s is the injected
        # mid-frame sleep, gated by wire_stall_prob.
        self.wire_flip_bits = float(wire_flip_bits)
        self.wire_truncate = float(wire_truncate)
        self.wire_garbage = float(wire_garbage)
        self.wire_duplicate = float(wire_duplicate)
        self.wire_stall_s = float(wire_stall_s)
        self.wire_stall_prob = float(wire_stall_prob)
        self.sleep = sleep
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._push_counts: Dict[Tuple[int, int], int] = {}
        self.fired: Dict[str, int] = {}      # site -> call index it fired at
        # (wire sites record a FIRE COUNT per "<kind>:<site>" key instead of
        # a call index — a rate site can fire many times)
        # Catches reported back by the stack (client/server/elastic pool):
        # exception type name -> count. Together with `fired` this is the
        # soak's corruption ledger: injected corruption must show up HERE,
        # never in the applied weights.
        self.wire_caught: Dict[str, int] = {}

    # -- the decision primitive ------------------------------------------
    def decide(self, site: str, rate: float) -> bool:
        """Consume one opportunity at ``site``; True with probability
        ``rate``, deterministically in the site's opportunity index."""
        if rate <= 0.0:
            # still consume the index so enabling a rate later keeps other
            # sites' sequences unchanged? No: a zero rate must be free, or
            # composing plans changes unrelated decision streams.
            return False
        with self._lock:
            n = self._counters.get(site, 0)
            self._counters[site] = n + 1
        return _unit(self.seed, site, n) < rate

    # -- client-side faults ----------------------------------------------
    def pull_fault(self) -> None:
        """Apply the pull-side faults: optional delay, optional transient
        error (raised BEFORE the pull reaches the wire)."""
        if self.pull_delay_s > 0.0 and (
            self.pull_delay_prob >= 1.0
            or self.decide("pull_delay", self.pull_delay_prob)
        ):
            self.sleep(self.pull_delay_s)
        if self.decide("pull_error", self.pull_error_rate):
            raise TransientFault("injected transient pull failure")

    def push_fault(self) -> str:
        """Verdict for one push: ``"ok"`` | ``"drop"`` | ``"dup"``; raises
        :class:`TransientFault` for an injected wire error."""
        if self.decide("push_error", self.push_error_rate):
            raise TransientFault("injected transient push failure")
        if self.decide("drop_push", self.drop_push):
            return "drop"
        if self.decide("dup_push", self.dup_push):
            return "dup"
        return "ok"

    # -- worker crashes --------------------------------------------------
    def record_push(self, ctx) -> None:
        """Count one push for ``ctx``'s (partition, attempt); kill the
        worker once ``crash_after_pushes`` pushes have gone through
        (attempt 0 of ``crash_partition`` only, at most once)."""
        if ctx is None or self.crash_partition is None:
            return
        if ctx.partitionId() != self.crash_partition or ctx.attemptNumber():
            return
        with self._lock:
            key = (ctx.partitionId(), ctx.attemptNumber())
            n = self._push_counts.get(key, 0) + 1
            self._push_counts[key] = n
            site = f"crash-partition-{self.crash_partition}"
            if n <= self.crash_after_pushes or site in self.fired:
                return
            self.fired[site] = n
        raise InjectedWorkerCrash(
            f"injected crash of partition {ctx.partitionId()} after "
            f"{self.crash_after_pushes} push(es)"
        )

    def maybe_crash_partition(self, ctx) -> None:
        """Kill the worker for ``crash_partition`` mid-partition (attempt 0
        only, at most once) — the synchronous-path crash, placed by the
        worker AFTER local training so the computed delta is genuinely
        lost and must be recomputed by the retry.

        ``dead_partitions`` members die here too, on EVERY attempt — a
        permanently lost machine rather than a one-off task flake. Those
        crashes are what the quorum path must commit around.
        """
        if ctx is None:
            return
        if ctx.partitionId() in self.dead_partitions:
            with self._lock:
                site = f"dead-partition-{ctx.partitionId()}"
                self.fired[site] = self.fired.get(site, -1) + 1
            raise InjectedWorkerCrash(
                f"injected permanent death of partition {ctx.partitionId()} "
                f"(attempt {ctx.attemptNumber()})"
            )
        if self.crash_partition is None:
            return
        if ctx.partitionId() != self.crash_partition or ctx.attemptNumber():
            return
        site = f"crash-partition-{self.crash_partition}"
        with self._lock:
            if site in self.fired:
                return
            self.fired[site] = 0
        raise InjectedWorkerCrash(
            f"injected mid-partition crash of partition {ctx.partitionId()}"
        )

    def straggler_stall(self, ctx) -> None:
        """Stall the worker for a ``straggler_stalls`` partition at the start
        of attempt 0 — deterministic slow-node injection. Backup attempts
        (attempt > 0) are NOT stalled, so a launched backup clone finishes
        first and first-finish-wins has a deterministic winner."""
        if ctx is None or not self.straggler_stalls:
            return
        if ctx.attemptNumber():
            return
        stall = self.straggler_stalls.get(ctx.partitionId())
        if stall:
            with self._lock:
                self.fired[f"straggle-partition-{ctx.partitionId()}"] = 0
            self.sleep(stall)

    # -- coarse crash points (fit chunks, arbitrary sites) ---------------
    def tick(self, site: str) -> None:
        """Count one call to ``site``; raise :class:`InjectedWorkerCrash`
        at the call index configured in ``crash_sites`` (0-based), once."""
        with self._lock:
            n = self._counters.get(f"tick:{site}", 0)
            self._counters[f"tick:{site}"] = n + 1
            target = self.crash_sites.get(site)
            if target is None or n != target or site in self.fired:
                return
            self.fired[site] = n
        raise InjectedWorkerCrash(
            f"injected crash at {site!r} call {n}"
        )

    # -- host-level sites (elastic control plane) ------------------------
    def host_kill(self, round_index: int) -> Optional[int]:
        """Host id to SIGKILL at round ``round_index`` (at most once per
        host site), or None. The elastic pool consults this right after
        issuing the round — the death is mid-round by construction."""
        host = self.kill_hosts.get(int(round_index))
        if host is None:
            return None
        site = f"kill-host-{host}"
        with self._lock:
            if site in self.fired:
                return None
            self.fired[site] = int(round_index)
        return int(host)

    def host_partition(self, round_index: int) -> Optional[int]:
        """Host whose heartbeat channel is cut starting at ``round_index``
        (at most once per host site), or None. The partition is one-sided
        and permanent: the host keeps computing and sending, the control
        plane stops hearing it — lease expiry does the rest."""
        host = self.partition_hosts.get(int(round_index))
        if host is None:
            return None
        site = f"partition-host-{host}"
        with self._lock:
            if site in self.fired:
                return None
            self.fired[site] = int(round_index)
        return int(host)

    def join_delay(self, host_id: int) -> int:
        """Rounds to defer admission of a freshly spawned ``host_id``."""
        delay = int(self.join_delay_rounds.get(int(host_id), 0))
        if delay > 0:
            with self._lock:
                self.fired.setdefault(f"delay-join-host-{int(host_id)}",
                                      delay)
        return delay

    # -- server-side hooks -----------------------------------------------
    def drop_server_push(self) -> bool:
        """True = the server should silently discard this delta (the push
        'arrived' but its application is lost)."""
        return self.decide("server_drop_push", self.server_drop_push)

    def delay_server_pull(self) -> None:
        if self.server_pull_delay_s > 0.0:
            self.sleep(self.server_pull_delay_s)

    # -- serving ----------------------------------------------------------
    def serving_stall(self, step_index: int) -> float:
        """Seconds of injected wall-clock stall at engine step
        ``step_index`` (deterministic: an explicit step → seconds map)."""
        return float(self.serving_stalls.get(int(step_index), 0.0))

    # -- wire-level faults (byte-level, through wrap_socket) ---------------
    #: sendall payloads at or below this many bytes are control traffic
    #: (1-byte opcodes, the 5-byte negotiation hello, 1/4-byte acks) and
    #: pass through untouched — every injected corruption therefore lands
    #: inside a FRAME (v2 header 18B + payload, legacy header 20B), which
    #: is what makes "every flip is caught by the framing layer" provable.
    _WIRE_CONTROL_MAX = 16

    def has_wire_faults(self) -> bool:
        """True when any wire-level site could fire (wrap_socket is then
        worth the shim; otherwise it returns the socket unwrapped)."""
        return (self.wire_flip_bits > 0.0 or self.wire_truncate > 0.0
                or self.wire_garbage > 0.0 or self.wire_duplicate > 0.0
                or (self.wire_stall_s > 0.0 and self.wire_stall_prob > 0.0))

    def wrap_socket(self, sock, site: str):
        """Wrap ``sock`` so outbound frames pass through this plan's wire
        sites. Returns ``sock`` unchanged when no wire site is active."""
        if not self.has_wire_faults():
            return sock
        return FaultySocket(sock, self, str(site))

    def note_wire_caught(self, where: str, err: BaseException) -> None:
        """The stack caught a typed frame error: record it in the ledger
        (keyed ``where:ExceptionType``). Called by ``SocketClient``,
        ``SocketServer``, and the elastic pool's readers."""
        key = f"{where}:{type(err).__name__}"
        with self._lock:
            self.wire_caught[key] = self.wire_caught.get(key, 0) + 1

    def wire_caught_total(self) -> int:
        return sum(self.wire_caught.values())

    def wire_fired_total(self, kinds: Tuple[str, ...] = (
            "wire_flip_bits", "wire_garbage", "wire_truncate")) -> int:
        """Total fires across sites for the given wire kinds (default: the
        CORRUPTING kinds — duplicates and stalls don't damage a frame)."""
        with self._lock:
            return sum(count for site, count in self.fired.items()
                       if site.split(":", 1)[0] in kinds)

    def _record_wire_fire(self, kind: str, site: str) -> int:
        """Count one fire of ``kind`` at ``site``; returns the 0-based fire
        index (seeds the deterministic mutation position draws)."""
        key = f"{kind}:{site}"
        with self._lock:
            n = self.fired.get(key, 0)
            self.fired[key] = n + 1
        return n

    def wire_send(self, sock, data: bytes, site: str) -> None:
        """Send ``data`` through the wire-fault sites (the FaultySocket
        sendall path). Control-sized payloads pass through untouched; for
        frames, every active kind draws one seeded per-opportunity verdict
        (all streams advance every frame, so enabling one kind never
        re-orders another's), and the first destructive verdict wins."""
        if len(data) <= self._WIRE_CONTROL_MAX:
            sock.sendall(data)
            return
        stall = (self.wire_stall_s > 0.0
                 and self.decide(f"wire_stall:{site}", self.wire_stall_prob))
        verdict = None
        for kind, rate in (("wire_truncate", self.wire_truncate),
                           ("wire_garbage", self.wire_garbage),
                           ("wire_flip_bits", self.wire_flip_bits),
                           ("wire_duplicate", self.wire_duplicate)):
            if self.decide(f"{kind}:{site}", rate) and verdict is None:
                verdict = kind
        if stall:
            self._record_wire_fire("wire_stall", site)

        def emit(payload: bytes) -> None:
            if stall:
                cut = max(1, len(payload) // 2)
                sock.sendall(payload[:cut])
                self.sleep(self.wire_stall_s)
                sock.sendall(payload[cut:])
            else:
                sock.sendall(payload)

        if verdict is None:
            emit(data)
            return
        n = self._record_wire_fire(verdict, site)
        if verdict == "wire_truncate":
            # Prefix then hard close: the peer sees EOF mid-frame. The
            # caller believes the send succeeded (like a real network cut —
            # the sender learns on its NEXT operation) and reconnects then.
            cut = 1 + int(_unit(self.seed, f"wire_truncate_cut:{site}", n)
                          * (len(data) - 1))
            try:
                sock.sendall(data[:cut])
                sock.shutdown(socket_mod.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
            return
        mutated = bytearray(data)
        if verdict == "wire_garbage":
            # Overwrite the frame head with deterministic junk. Byte 0 is
            # forced to 0xFF — neither v2 magic nor an ASCII digit — so the
            # receiver types it immediately and quarantines the connection
            # (the rest of the mutated stream is never parsed).
            junk = hashlib.blake2b(
                f"{self.seed}:wire_garbage_bytes:{site}:{n}".encode(),
                digest_size=32,
            ).digest()
            span = min(len(junk), len(mutated))
            mutated[:span] = junk[:span]
            mutated[0] = 0xFF
        elif verdict == "wire_flip_bits":
            pos = int(_unit(self.seed, f"wire_flip_pos:{site}", n)
                      * len(mutated))
            bit = int(_unit(self.seed, f"wire_flip_bit:{site}", n) * 8)
            mutated[pos] ^= 1 << bit
        elif verdict == "wire_duplicate":
            emit(bytes(mutated))  # the original ...
        emit(bytes(mutated))      # ... and the (possibly mutated) frame


class FaultySocket:
    """A socket shim that routes outbound bytes through a
    :class:`FaultPlan`'s wire sites (:meth:`FaultPlan.wire_send`).

    Sits UNDER the framing layer: ``sendall`` is intercepted, everything
    else (``recv``, ``recv_into``, ``settimeout``, ``close``, …) delegates
    to the wrapped socket, so ``utils.sockets``' send/receive and the
    stall-deadline save/restore work unchanged. Wrapping only the sender
    side of each direction covers the whole wire: the client's shim
    corrupts client→server frames (caught by the server), the server's
    shim corrupts replies (caught by the client).
    """

    def __init__(self, sock, plan: FaultPlan, site: str):
        self._sock = sock
        self._plan = plan
        self._site = site

    def sendall(self, data) -> None:
        self._plan.wire_send(self._sock, bytes(data), self._site)

    def __getattr__(self, name):
        return getattr(self._sock, name)


class FaultyClient(BaseParameterClient):
    """Wrap a parameter client with a :class:`FaultPlan`.

    Sits at the transport layer: whatever stacks above it (compression,
    :class:`~elephas_tpu_torch.resilience.policy.ResilientClient` retries) sees
    injected faults exactly as it would see real network ones. Dropped
    pushes report success to the caller — the delta is lost in flight, the
    worker never knows, which is precisely the failure mode async training
    must converge through.
    """

    def __init__(self, inner: BaseParameterClient, plan: FaultPlan):
        self.inner = inner
        self.plan = plan

    def _task_ctx(self):
        from ..data import TaskContext

        return TaskContext.get()

    def get_parameters(self):
        self.plan.pull_fault()
        return self.inner.get_parameters()

    def _push(self, do_push: Callable[[], None]) -> None:
        self.plan.record_push(self._task_ctx())
        verdict = self.plan.push_fault()
        if verdict == "drop":
            return
        do_push()
        if verdict == "dup":
            do_push()

    def update_parameters(self, delta) -> None:
        self._push(lambda: self.inner.update_parameters(delta))

    def update_parameters_tagged(self, task_id: str, delta,
                                 attempt=None) -> None:
        # Forward the attempt tag only when set: plain two-arg inner clients
        # (and pre-fencing fakes in tests) keep working unchanged.
        if attempt is None:
            self._push(
                lambda: self.inner.update_parameters_tagged(task_id, delta)
            )
        else:
            self._push(
                lambda: self.inner.update_parameters_tagged(
                    task_id, delta, attempt=attempt
                )
            )

    def get_version(self) -> int:
        return self.inner.get_version()

    def register_attempt(self, task_id: str, attempt: int) -> bool:
        return self.inner.register_attempt(task_id, attempt)

    def commit_attempt(self, task_id: str) -> None:
        self.inner.commit_attempt(task_id)

    def close(self) -> None:
        self.inner.close()
