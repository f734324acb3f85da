"""Admission control + the prefill-vs-decode decision.

A copy of ``elephas_tpu/serving/scheduler.py`` (framework-free), kept here
so the port imports nothing of the JAX package. The page-budget arguments
of :meth:`Scheduler.decide` serve the paged engine.

The scheduler is pure host-side bookkeeping (no array library): a BOUNDED
FIFO+priority queue in front of the slot budget. Boundedness is the
backpressure mechanism — a full queue REJECTS at submit time with a
machine-readable reason instead of buffering unboundedly and timing every
caller out later (the fail-fast discipline a loaded service needs;
callers retry against another replica). Within the queue, higher
``priority`` runs first and FIFO breaks ties, so equal-priority traffic
keeps arrival order (no starvation among peers; a persistent stream of
high-priority work CAN starve low priority — that is the knob's contract,
documented, not accidental).

The per-iteration policy (:meth:`Scheduler.decide`) is prefill-first:
admit waiting work into free slots before running the batched decode
step. Prefill-first maximizes batch occupancy (a freshly admitted row
joins every subsequent decode step) and minimizes TTFT; the decode batch
it momentarily delays loses one step of latency, which continuous
batching amortizes across the whole rollout.

Admission is deadline-aware: before each decide the engine sheds queued
requests that provably cannot meet their ``deadline_s``
(:meth:`Scheduler.unmeetable` — deadline already expired, or the
remaining token budget times the engine's per-token latency floor
overruns it) with a distinct ``"shed"`` finish reason, instead of
admitting them and reaping them late. Shedding hopeless work at the
queue is what keeps slots for requests that can still succeed — the
load-shedding discipline the reference's fleet policy layer extends
across partitions.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from .metrics import RequestTiming


class AdmissionError(Exception):
    """A submit was rejected; ``reason`` is machine-readable
    (``"queue_full"``, ``"prompt_too_long"``, ``"length_exceeds_cache"``,
    ``"bad_request"``)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"{reason}: {detail}" if detail else reason)


@dataclass
class ServingRequest:
    """One in-flight generation request (host-side state; the device state
    is its slot's rows of the :class:`~elephas_tpu_torch.serving.cache.SlotKVCache`)."""

    request_id: str
    prompt: Any                    # np.int32 [T0]
    max_new: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    priority: int = 0
    seed: int = 0
    on_token: Optional[Callable] = None  # (request_id, token, done) -> None
    timing: Optional[RequestTiming] = None
    # resilience: absolute deadline (engine-clock units) and the lazy-
    # deletion tombstone — a cancelled entry stays in the heap but is
    # skipped at pop (O(1) cancel, no heap rebuild)
    deadline_at: Optional[float] = None
    cancelled: bool = False
    # engine-managed decode state
    slot: Optional[int] = None
    carry: Optional[int] = None    # last emitted token, not yet in cache
    next_pos: int = 0              # absolute position `carry` will occupy
    prefill_pos: int = 0           # prompt tokens already inserted (chunked)
    generated: List[int] = field(default_factory=list)
    # paged-memory state (engine-managed; all inert on the dense path)
    adapter_id: int = 0            # multi-tenant LoRA variant for this req
    resume_prompt: Any = None      # prompt ++ generated after a preemption
    admit_seq: int = -1            # admission stamp (newest is preempted 1st)
    preemptions: int = 0
    # weight-rollover attribution (engine-managed): the engine's
    # weights_version when this request's prefill started, and one version
    # stamp per emitted token (the version live at the decode round that
    # emitted it — swap boundaries fall only between rounds)
    prefill_version: int = 0
    token_versions: List[int] = field(default_factory=list)


class Scheduler:
    """Bounded FIFO+priority queue + the per-iteration action policy."""

    def __init__(self, max_queue: int = 64):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self._heap: List[Tuple[int, int, ServingRequest]] = []
        self._live = 0                 # heap entries NOT tombstoned
        self._seq = itertools.count()  # FIFO tiebreak within a priority
        # negative sequence numbers sort BEFORE every FIFO entry of the
        # same priority: requeued (preempted) work resumes first
        self._rseq = itertools.count(-1, -1)

    def __len__(self) -> int:
        return self._live

    @property
    def queue_depth(self) -> int:
        return self._live

    def push(self, req: ServingRequest) -> None:
        """Enqueue or reject-with-reason (the backpressure point)."""
        if self._live >= self.max_queue:
            raise AdmissionError(
                "queue_full",
                f"{self._live} waiting >= max_queue {self.max_queue}")
        # negated priority: heapq is a min-heap, higher priority runs first
        heapq.heappush(self._heap, (-int(req.priority), next(self._seq), req))
        self._live += 1

    def pop(self) -> Optional[ServingRequest]:
        while self._heap:
            req = heapq.heappop(self._heap)[2]
            if req.cancelled:
                continue  # tombstone: already discarded, heap entry stale
            self._live -= 1
            return req
        return None

    def peek(self) -> Optional[ServingRequest]:
        """The request ``pop`` would return, without removing it (the
        engine's page-admission check inspects the head's prompt).
        Tombstones at the front are drained — they are dead entries
        ``pop`` would skip anyway."""
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][2] if self._heap else None

    def requeue(self, req: ServingRequest) -> None:
        """Put a PREEMPTED request back at the FRONT of its priority class
        (negative sequence — it beats every FIFO entry), bypassing the
        ``max_queue`` bound: the request was already admitted once, and
        rejecting it now would turn backpressure into data loss."""
        req.cancelled = False
        heapq.heappush(self._heap,
                       (-int(req.priority), next(self._rseq), req))
        self._live += 1

    def discard(self, req: ServingRequest) -> bool:
        """Cancel a QUEUED request in O(1): tombstone it, fix the live
        count, leave the heap entry for ``pop`` to skip. Returns False if
        the request was already cancelled (idempotent)."""
        if req.cancelled:
            return False
        req.cancelled = True
        self._live -= 1
        return True

    def expired(self, now: float) -> List[ServingRequest]:
        """Queued requests whose deadline has passed (NOT yet discarded —
        the caller decides what a timeout means)."""
        return [
            entry[2] for entry in self._heap
            if not entry[2].cancelled
            and entry[2].deadline_at is not None
            and now >= entry[2].deadline_at
        ]

    def unmeetable(self, now: float,
                   itl_s: Optional[float] = None) -> List[ServingRequest]:
        """Queued requests that PROVABLY cannot meet their deadline: the
        deadline already passed, or — given a per-token latency floor
        ``itl_s`` — even emitting at that floor overruns it
        (``now + remaining_budget * itl_s > deadline_at``). The engine
        sheds these at decide time with ``finish_reason="shed"`` instead
        of admitting them and reaping them late: a request that cannot
        finish should never cost a slot, a prefill, or the decode batch a
        row. NOT yet discarded — the caller owns the terminal record."""
        out = []
        for entry in self._heap:
            req = entry[2]
            if req.cancelled or req.deadline_at is None:
                continue
            budget = max(0, req.max_new - len(req.generated))
            if now >= req.deadline_at or (
                    itl_s is not None
                    and now + budget * float(itl_s) > req.deadline_at):
                out.append(req)
        return out

    def decide(self, free_slots: int, active_slots: int,
               has_partial: bool = False,
               last_action: Optional[str] = None,
               free_pages: Optional[int] = None,
               need_pages: Optional[int] = None,
               reserve_pages: int = 0) -> str:
        """The next engine action: ``"prefill"`` (waiting work + a free
        slot), else ``"decode"`` (any active slot), else ``"idle"``.

        With ``has_partial`` (a long prompt mid-chunked-prefill) the
        choice is ``"prefill_chunk"`` ALTERNATED with ``"decode"``: the
        chunk train makes progress every other step while the active
        decode rows keep emitting — the bounded inter-token-latency
        contract chunked prefill exists for. No NEW admission happens
        while a partial is open (one prompt ingests at a time, so the
        chunk kernel compiles per chunk bucket, not per concurrency
        pattern); with no active rows the chunks just run back-to-back.

        On the paged engine admission is gated by free PAGES, not just
        free slots: ``need_pages`` is what the queue HEAD would allocate
        (insert + first decode write, beyond its cached prefix) and
        ``free_pages`` the binding partition's free count — admission
        requires ``need_pages <= free_pages``. Only the head is ever
        considered, so a long-prompt head is never overtaken by cheaper
        requests behind it: it admits as soon as eviction/releases free
        its pages (the no-starvation contract, pinned in the tests).

        ``reserve_pages`` holds back pages the LIVE slots may still
        claim — on a speculating engine, each active slot's next verify
        round can commit up to ``speculate_k`` tokens at once, and those
        pages must stay claimable or an accept burst hits an
        unrecoverable allocator failure mid-commit. Admitting by the
        head's need alone (the pre-reservation bug) let a new prompt eat
        exactly the pages a burst needed.
        """
        if has_partial:
            if active_slots > 0 and last_action == "prefill_chunk":
                return "decode"
            return "prefill_chunk"
        if (self._live and free_slots > 0
                and (free_pages is None or need_pages is None
                     or need_pages + max(0, int(reserve_pages))
                     <= free_pages)):
            return "prefill"
        if active_slots > 0:
            return "decode"
        return "idle"
