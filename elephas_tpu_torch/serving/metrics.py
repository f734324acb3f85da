"""Serving metrics: per-request latency accounting + engine gauges.

A copy of ``elephas_tpu/serving/metrics.py`` (framework-free), kept here so
the port imports nothing of the JAX package.

Every request carries one :class:`RequestTiming` through its lifecycle
(submitted → admitted/prefilled → first token → finished); the engine
stamps it with a caller-injectable ``clock`` so tests pin exact numbers
with a fake clock instead of sleeping. :class:`ServingMetrics` aggregates
finished timings into the quantities a capacity dashboard actually wants —
TTFT, queue wait, decode tokens/sec (p50/p95 over a bounded window of
completed requests) — plus engine-level gauges: active slots, queue depth,
and batch occupancy (mean fraction of decode-batch rows doing real work;
THE continuous-batching health number — a low value means the slot budget
is burning FLOPs on padding rows).

``snapshot()`` returns one plain-JSON-able dict (``json.dumps`` must
succeed on it — pinned in tests); nothing here imports an array library.
"""

from __future__ import annotations

import json
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass
class RequestTiming:
    """Lifecycle stamps for one request (``clock`` units, typically
    seconds). ``None`` until the stage happens."""

    request_id: str
    prompt_tokens: int
    submitted_at: float
    admitted_at: Optional[float] = None      # prefill-insert started
    first_token_at: Optional[float] = None   # first generated token emitted
    finished_at: Optional[float] = None
    generated_tokens: int = 0
    # "eos"|"length"|"deadline"|"cancelled"|"shed"
    finish_reason: Optional[str] = None

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, from SUBMIT (queue wait included — the
        latency the caller experiences, not the latency the GPU sees)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def decode_tokens_per_sec(self) -> Optional[float]:
        """Generated tokens over the admitted→finished span."""
        if self.finished_at is None or self.admitted_at is None:
            return None
        dt = self.finished_at - self.admitted_at
        if dt <= 0:
            return None
        return self.generated_tokens / dt


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list (no numpy — the
    snapshot must be buildable host-side with zero array deps)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


@dataclass
class ServingMetrics:
    """Engine-level counters/gauges + a bounded window of finished
    request timings."""

    n_slots: int
    window: int = 1024  # finished-request timings kept for percentiles

    submitted: int = 0
    rejected: Counter = field(default_factory=Counter)  # reason → count
    completed: int = 0
    cancelled: Counter = field(default_factory=Counter)  # reason → count
    results_evicted: int = 0  # finished records dropped by the retention cap
    tokens_generated: int = 0
    prefills: int = 0
    decode_steps: int = 0
    # fast-path counters: fused multi-token decode + chunked prefill.
    # decode_steps counts LOGICAL steps (a fused block of K adds K), so
    # occupancy and steady-state rates stay comparable across decode loops.
    fused_blocks: int = 0       # fused multi-step programs launched
    fused_steps: int = 0        # logical steps covered by those blocks
    prefill_chunks: int = 0     # chunk inserts (beyond whole-prompt ones)
    # speculative decoding: the engine's speculate_k (spec_k == 1 means
    # the feature is off and the spec section is absent from snapshots)
    # plus device-committed token accounting per verify round. Pinned
    # invariant: spec_emitted == spec_accepted + spec_rows (each active
    # row commits its accepted run plus one correction per round).
    spec_k: int = 1
    # weight rollover: the engine's current weights version (0 until the
    # first swap stamps one) and how many hot swaps happened. Always in
    # the snapshot — rollover must be observable even when the streaming
    # subsystem is absent (a static engine reads version 0, swaps 0).
    weights_version: int = 0
    weight_swaps: int = 0
    spec_rounds: int = 0        # draft+verify program launches
    spec_drafted: int = 0       # drafter proposals scored
    spec_accepted: int = 0      # proposals matching the engine's rule
    spec_emitted: int = 0       # tokens committed by verify rounds
    spec_rows: int = 0          # Σ active rows over verify rounds
    _occupancy_sum: float = 0.0  # Σ (active rows / slots) over decode steps
    _finished: Deque[RequestTiming] = field(default_factory=deque)
    # wall-clock histograms (bounded deques, window entries each). These
    # are measured by the engine's ``perf_clock`` (time.perf_counter by
    # default — dispatch overhead is a real-time quantity), NEVER the
    # lifecycle ``clock``: fake-clock latency tests must not see extra
    # clock reads. Fleet trace replay injects a simulated perf_clock so
    # the histograms are deterministic in tier-1.
    _itl: Deque[float] = field(default_factory=deque)       # s per token
    _dispatch: Deque[float] = field(default_factory=deque)  # host s per token
    _chunk_stall: Deque[float] = field(default_factory=deque)  # s per chunk
    _accept_rate: Deque[float] = field(default_factory=deque)  # per round
    _spec_tokens: Deque[float] = field(default_factory=deque)  # emitted/row
    # per-tenant accounting keyed by adapter_id: fairness must be
    # OBSERVABLE (the fleet bench asserts tenant isolation off this), so
    # every submit/admission/terminal event also lands in its tenant's row
    _tenants: Dict[int, Dict[str, object]] = field(default_factory=dict)

    def _tenant(self, adapter_id: int) -> Dict[str, object]:
        row = self._tenants.get(int(adapter_id))
        if row is None:
            row = {"submitted": 0, "admitted": 0, "tokens": 0,
                   "finished": Counter()}
            self._tenants[int(adapter_id)] = row
        return row

    def observe_reject(self, reason: str) -> None:
        self.rejected[reason] += 1

    def observe_cancel(self, reason: str, adapter_id: int = 0,
                       tokens: int = 0) -> None:
        """One request terminated early: ``"deadline"`` (engine reaped it),
        ``"cancelled"`` (caller asked), or ``"shed"`` (deadline provably
        unmeetable at admission time — dropped before it cost a slot)."""
        self.cancelled[reason] += 1
        row = self._tenant(adapter_id)
        row["finished"][reason] += 1
        row["tokens"] += int(tokens)

    def observe_result_evicted(self) -> None:
        self.results_evicted += 1

    def observe_submit(self, adapter_id: int = 0) -> None:
        self.submitted += 1
        self._tenant(adapter_id)["submitted"] += 1

    def observe_swap(self, version: int) -> None:
        """One hot weight swap; ``version`` is the version now serving
        (NOT necessarily higher than the last one — a rollback republishes
        an older version and the gauge must say so)."""
        self.weight_swaps += 1
        self.weights_version = int(version)

    def observe_prefill(self, adapter_id: int = 0) -> None:
        self.prefills += 1
        self._tenant(adapter_id)["admitted"] += 1

    def observe_decode_step(self, n_active: int) -> None:
        self.decode_steps += 1
        self._occupancy_sum += n_active / self.n_slots

    def _push(self, dq: Deque[float], val: float) -> None:
        dq.append(val)
        while len(dq) > self.window:
            dq.popleft()

    def observe_decode_block(self, n_active: int, n_steps: int,
                             block_s: Optional[float] = None,
                             host_s: Optional[float] = None) -> None:
        """One decode PROGRAM launch covering ``n_steps`` logical steps
        (1 = a single step; >1 = a fused block). ``block_s`` is
        the wall-clock the program took (→ inter-token latency =
        block_s / n_steps); ``host_s`` is the host-side time NOT spent
        inside the device program (dispatch + python emit loop) — the
        overhead fusion exists to amortize."""
        for _ in range(int(n_steps)):
            self.observe_decode_step(n_active)
        if n_steps > 1:
            self.fused_blocks += 1
            self.fused_steps += int(n_steps)
        if block_s is not None and n_steps > 0:
            self._push(self._itl, block_s / n_steps)
        if host_s is not None and n_steps > 0:
            self._push(self._dispatch, host_s / n_steps)

    def observe_spec_round(self, n_active: int, n_drafted: int,
                           n_accepted: int, n_emitted: int,
                           block_s: Optional[float] = None,
                           host_s: Optional[float] = None) -> None:
        """One speculative draft+verify round over ``n_active`` live rows:
        ``n_drafted`` proposals were scored in the fused verify program,
        ``n_accepted`` matched the engine's selection rule, and
        ``n_emitted = n_accepted + n_active`` tokens were committed (each
        row's accepted run plus its correction). A round counts ONE
        logical decode step — occupancy stays per-launch, and the spec
        counters carry the real multi-token accounting. ``block_s``
        spreads over the tokens the round emitted per row, so the
        inter-token-latency histogram directly shows the speculative
        speedup; ``host_s`` likewise (drafting cost included by the
        caller)."""
        self.spec_rounds += 1
        self.spec_drafted += int(n_drafted)
        self.spec_accepted += int(n_accepted)
        self.spec_emitted += int(n_emitted)
        self.spec_rows += int(n_active)
        self.observe_decode_step(n_active)
        if n_drafted > 0:
            self._push(self._accept_rate, n_accepted / n_drafted)
        if n_active > 0 and n_emitted > 0:
            self._push(self._spec_tokens, n_emitted / n_active)
            if block_s is not None:
                self._push(self._itl, block_s * n_active / n_emitted)
            if host_s is not None:
                self._push(self._dispatch, host_s * n_active / n_emitted)

    def observe_prefill_chunk(self, n_tokens: int, stalled_slots: int,
                              chunk_s: Optional[float] = None) -> None:
        """One chunk insert of ``n_tokens`` while ``stalled_slots`` active
        decode rows waited on it. The stall histogram records chunk
        wall-clock ONLY when somebody actually stalled — it measures the
        inter-token-latency spike chunking bounds, not prefill cost."""
        self.prefill_chunks += 1
        if chunk_s is not None and stalled_slots > 0:
            self._push(self._chunk_stall, chunk_s)

    def observe_finish(self, timing: RequestTiming,
                       adapter_id: int = 0) -> None:
        self.completed += 1
        self.tokens_generated += timing.generated_tokens
        row = self._tenant(adapter_id)
        row["finished"][timing.finish_reason or "eos"] += 1
        row["tokens"] += int(timing.generated_tokens)
        self._finished.append(timing)
        while len(self._finished) > self.window:
            self._finished.popleft()

    @property
    def batch_occupancy(self) -> float:
        """Mean active-rows / slots over all decode steps so far."""
        if not self.decode_steps:
            return 0.0
        return self._occupancy_sum / self.decode_steps

    def _dist(self, vals: List[float]) -> Dict[str, float]:
        vals = sorted(v for v in vals if v is not None)
        if not vals:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "mean": 0.0}
        return {
            "count": len(vals),
            "p50": round(_percentile(vals, 0.50), 6),
            "p95": round(_percentile(vals, 0.95), 6),
            "mean": round(sum(vals) / len(vals), 6),
        }

    def snapshot(self, active_slots: int = 0, queue_depth: int = 0,
                 memory: Optional[Dict[str, object]] = None
                 ) -> Dict[str, object]:
        """One JSON-able dict of everything above. The live gauges are
        the ENGINE's to report (the metrics object never reaches into the
        scheduler), so they arrive as arguments — ``memory`` is the paged
        engine's page/prefix-cache section
        (:meth:`~elephas_tpu_torch.serving.memory.PagedKVCache.memory_stats`),
        included only when provided."""
        fin = list(self._finished)
        out = {
            "engine": {
                "n_slots": self.n_slots,
                "active_slots": active_slots,
                "queue_depth": queue_depth,
                "batch_occupancy": round(self.batch_occupancy, 4),
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "weights_version": self.weights_version,
                "weight_swaps": self.weight_swaps,
            },
            "counters": {
                "submitted": self.submitted,
                "rejected": dict(self.rejected),
                "completed": self.completed,
                "cancelled": dict(self.cancelled),
                "results_evicted": self.results_evicted,
                "tokens_generated": self.tokens_generated,
            },
            "requests": {
                "ttft_s": self._dist([t.ttft for t in fin]),
                "queue_wait_s": self._dist([t.queue_wait for t in fin]),
                "decode_tokens_per_sec": self._dist(
                    [t.decode_tokens_per_sec for t in fin]),
            },
            # fast-path observability (its own section: the "engine" keys
            # above are pinned exactly in tests and dashboards)
            "fastpath": {
                "fused_blocks": self.fused_blocks,
                "fused_steps": self.fused_steps,
                "prefill_chunks": self.prefill_chunks,
                "inter_token_latency_s": self._dist(list(self._itl)),
                "dispatch_overhead_s": self._dist(list(self._dispatch)),
                "prefill_chunk_stall_s": self._dist(list(self._chunk_stall)),
            },
        }
        if self.spec_k > 1:
            # speculative section: present IFF the engine speculates, so
            # dashboards key feature detection off the snapshot itself
            out["fastpath"].update({
                "spec_rounds": self.spec_rounds,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "spec_emitted": self.spec_emitted,
                "spec_rows": self.spec_rows,
                "acceptance_rate": self._dist(list(self._accept_rate)),
                "emitted_per_row_per_round": self._dist(
                    list(self._spec_tokens)),
            })
        # per-tenant accounting (JSON object keys must be strings)
        out["tenants"] = {
            str(aid): {
                "submitted": row["submitted"],
                "admitted": row["admitted"],
                "tokens": row["tokens"],
                "finished": dict(row["finished"]),
            }
            for aid, row in sorted(self._tenants.items())
        }
        if memory is not None:
            out["memory"] = memory
        return out

    def to_json(self, **gauges) -> str:
        return json.dumps(self.snapshot(**gauges))
