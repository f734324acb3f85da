"""The continuous-batching serving loop (port of the dense path of
``elephas_tpu/serving/engine.py``).

``ServingEngine`` multiplexes every in-flight request through one batched
decode step over all slots:

    submit() ──▶ scheduler (bounded queue) ──▶ prefill into a free slot
                                                     │ first token
                                                     ▼
                     one decode step over ALL slots per step()
                     (or K steps back to back when the fused fast path
                      engages; per-row positions; free slots ride along
                      as no-op rows)
                                                     │ token(s) per slot
                                                     ▼
                     EOS / length? → release slot → next queued request

The decode batch is always the full ``[n_slots]`` geometry. Free slots
decode a dummy token at position 0; the garbage K/V that writes is dead by
the staleness-repair invariant (the next occupant's prefill overwrites it
before anything attends it).

Ported fast paths, as in the reference: chunked prefill (``prefill_chunk=``:
a long prompt lands as fixed-size chunks interleaved with decode steps) and
fused multi-token decode (``fuse_k=``: K decode steps launched back to back
with ONE host read of their tokens, when no admission, chunk train,
deadline or EOS-able request could observe the difference). The per-slot
step state — carry token, position, temperature, seed, liveness — lives in
device tensors that the decode step advances; the host writes single rows
at admission and release, and reads the emitted tokens once per decode
block (the only per-step host sync, as in the reference).

Selection is per slot (:func:`~elephas_tpu_torch.models.transformer.
select_slot_tokens`): greedy rows and sampled rows coexist in one batch, and
a request's sample stream is keyed by ``(seed, position)``, independent of
slot assignment and of what else is co-batched. Greedy outputs match the
reference's per-request ``TransformerLM.generate``.

Paged KV memory, meshes, speculative decoding and fault injection are later
slices of the port and raise ``NotImplementedError``.

Time is injectable (``clock=``): latency tests pin exact TTFT/queue-wait
numbers with a fake clock. The latency histograms read a separate
``perf_clock`` (``time.perf_counter`` by default).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..models.transformer import select_slot_tokens
from .cache import SlotKVCache, bucket_length
from .metrics import RequestTiming, ServingMetrics
from .scheduler import AdmissionError, Scheduler, ServingRequest


def _decode_block(model, params, cache, tokens, pos, temps, seeds, live,
                  n_steps: int, sampled: bool):
    """``n_steps`` batched decode steps over every slot, each with per-slot
    selection: ``tokens``/``pos``/``temps``/``seeds``/``live`` ``[S]`` →
    ``(emitted [S, n_steps], tokens, pos)``. Live rows advance their carry
    token and position on the device; non-live rows neither advance nor
    change their carry (their emitted entries are garbage the host
    ignores). The cache is written in place. Rows are independent and
    selection is ``(seed, position)``-keyed, so ``n_steps`` steps here
    emit exactly what ``n_steps`` single-step calls would."""
    emitted = []
    for _ in range(n_steps):
        logits, cache = model.decode_step(params, tokens, pos, cache)
        emit = select_slot_tokens(logits, pos + 1, temps, seeds, sampled)
        tokens = torch.where(live, emit, tokens)
        pos = torch.where(live, pos + 1, pos)
        emitted.append(emit)
    return torch.stack(emitted, dim=1), tokens, pos


def _wait(t: torch.Tensor) -> None:
    """Block until the work producing ``t`` has finished on its device."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


@dataclass
class FinishedRequest:
    """Terminal record handed back by :meth:`ServingEngine.result` /
    :meth:`ServingEngine.drain`.

    ``token_versions[i]`` is the weights version live at the decode round
    that emitted ``tokens[i]``. ``version_first``/``version_last``
    summarize the stream's span (``-1`` on a request cancelled before its
    first token)."""

    request_id: str
    prompt: np.ndarray            # [T0] int32
    tokens: List[int]             # generated continuation (EOS included)
    # "eos" | "length" | "deadline" | "cancelled" | "shed"
    finish_reason: str
    timing: RequestTiming
    token_versions: List[int] = field(default_factory=list)
    version_first: int = -1
    version_last: int = -1


class ServingEngine:
    """Continuous-batching inference over one model: ``submit() →
    request_id``, ``step()`` (one scheduler action), ``drain()`` (run to
    empty). ``device`` must be the model's and the params' device (default
    ``"cuda"``; raises without CUDA unless ``"cpu"`` is asked for)."""

    def __init__(self, model, params, n_slots: int = 8,
                 max_len: Optional[int] = None, max_queue: int = 64,
                 mesh=None, clock: Callable[[], float] = time.monotonic,
                 metrics_window: int = 1024, max_finished: int = 1024,
                 fault_plan=None, prefill_chunk: Optional[int] = None,
                 fuse_k: int = 1, paged: bool = False,
                 speculate_k: int = 1, drafter=None,
                 perf_clock: Callable[[], float] = time.perf_counter,
                 itl_estimate_s: Optional[float] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if paged:
            raise NotImplementedError(
                "the paged KV engine needs the paged-attention kernel K5, not "
                "ported yet (ROADMAP.md queue 1, 'Paged serving (K5)')")
        if mesh is not None or speculate_k > 1 or drafter is not None:
            raise NotImplementedError(
                "mesh serving and speculative decoding are not ported yet "
                "(ROADMAP.md queue 1, 'Speculation and sharding')")
        if fault_plan is not None:
            raise NotImplementedError(
                "fault injection is not ported yet (ROADMAP.md queue 1, "
                "'Resilience, streaming and fleet')")
        if max_finished < 1:
            raise ValueError(f"max_finished must be >= 1, got {max_finished}")
        if fuse_k < 1:
            raise ValueError(f"fuse_k must be >= 1, got {fuse_k}")
        if speculate_k < 1:
            raise ValueError(f"speculate_k must be >= 1, got {speculate_k}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if itl_estimate_s is not None and itl_estimate_s <= 0:
            raise ValueError(
                f"itl_estimate_s must be > 0, got {itl_estimate_s}")
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self._check_params(params)
        self.model = model
        self.params = params
        self.clock = clock
        # latency-histogram clock (ITL / dispatch / chunk stalls), separate
        # from ``clock`` so fake lifecycle clocks never see extra reads
        self._perf = perf_clock
        # per-token latency floor for deadline-aware admission: a queued
        # request whose remaining budget cannot finish by its deadline even
        # at this rate is SHED at decide time. None = only already-expired
        # queued work is shed.
        self.itl_estimate_s = (None if itl_estimate_s is None
                               else float(itl_estimate_s))
        self.max_finished = int(max_finished)
        # chunk size rounds UP to the insert bucket grid so a full chunk is
        # never padded
        self.prefill_chunk = (None if prefill_chunk is None
                              else bucket_length(int(prefill_chunk)))
        self.fuse_k = int(fuse_k)
        self.scheduler = Scheduler(max_queue=max_queue)
        self.metrics = ServingMetrics(n_slots=n_slots, window=metrics_window)
        self.kv = SlotKVCache(model, params, n_slots, max_len=max_len)
        # per-slot step state, DEVICE-resident: the decode step advances it;
        # the host writes single rows at admission/release
        S, dev = self.kv.n_slots, self.device
        self._tok = torch.zeros(S, dtype=torch.int64, device=dev)    # carry
        self._pos = torch.zeros(S, dtype=torch.int32, device=dev)    # write head
        self._temps = torch.zeros(S, dtype=torch.float32, device=dev)  # <=0 greedy
        self._seeds = torch.zeros(S, dtype=torch.int64, device=dev)
        self._live = torch.zeros(S, dtype=torch.bool, device=dev)
        self.weights_version = 0
        self._partial: Optional[ServingRequest] = None  # open chunk train
        self._last_action: Optional[str] = None
        self._slot_req: Dict[int, ServingRequest] = {}
        self._requests: Dict[str, ServingRequest] = {}
        self._finished: Dict[str, FinishedRequest] = {}
        self._next_id = 0

    def _check_params(self, params) -> None:
        for k, v in params.items():
            if v.device != self.device:
                raise ValueError(f"param {k!r} is on {v.device}, engine on "
                                 f"{self.device}")

    # -- submission ------------------------------------------------------
    def submit(self, prompt, max_new: int, temperature: float = 0.0,
               eos_id: Optional[int] = None, priority: int = 0,
               seed: int = 0, on_token: Optional[Callable] = None,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> str:
        """Enqueue one generation request; returns its id. Raises
        :class:`AdmissionError` (with a machine-readable ``.reason``) on
        validation failure or queue backpressure — rejected work never
        holds a queue entry or a slot. ``deadline_s`` bounds the request's
        whole lifetime from submit: once exceeded it is reaped at the next
        ``step()`` with ``finish_reason="deadline"`` and whatever tokens it
        produced."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        T0 = prompt.shape[0]
        rid = request_id or f"req-{self._next_id}"
        try:
            if rid in self._requests or rid in self._finished:
                raise AdmissionError("bad_request",
                                     f"duplicate request_id {rid!r}")
            if max_new < 1:
                raise AdmissionError("bad_request",
                                     f"max_new must be >= 1, got {max_new}")
            if deadline_s is not None and deadline_s <= 0:
                raise AdmissionError(
                    "bad_request",
                    f"deadline_s must be > 0, got {deadline_s}")
            if T0 < 1 or T0 > self.kv.max_len:
                raise AdmissionError(
                    "prompt_too_long",
                    f"prompt length {T0} not in [1, {self.kv.max_len}]")
            if T0 + int(max_new) > self.kv.max_len:
                raise AdmissionError(
                    "length_exceeds_cache",
                    f"prompt {T0} + max_new {max_new} exceeds "
                    f"max_len {self.kv.max_len}")
            # out-of-range ids would index past the embedding on the
            # device (the reference's gather clamps them instead)
            if prompt.min() < 0 or prompt.max() >= self.model.vocab:
                raise AdmissionError(
                    "bad_request",
                    f"prompt token ids must be in [0, {self.model.vocab})")
            submitted_at = self.clock()
            req = ServingRequest(
                request_id=rid, prompt=prompt, max_new=int(max_new),
                temperature=float(temperature), eos_id=eos_id,
                priority=int(priority), seed=int(seed), on_token=on_token,
                deadline_at=(None if deadline_s is None
                             else submitted_at + float(deadline_s)),
                timing=RequestTiming(request_id=rid, prompt_tokens=int(T0),
                                     submitted_at=submitted_at))
            self.scheduler.push(req)
        except AdmissionError as e:
            self.metrics.observe_reject(e.reason)
            raise
        self._next_id += 1
        self._requests[rid] = req
        self.metrics.observe_submit()
        return rid

    # -- the loop --------------------------------------------------------
    def step(self) -> str:
        """Run ONE scheduler action — ``"prefill"``, ``"prefill_chunk"``,
        ``"decode"`` or ``"idle"`` — and return which one ran. Expired
        deadlines are reaped first, so a timed-out request frees its slot
        before this step's work is chosen."""
        self._shed_unmeetable()
        self._reap_expired()
        action = self.scheduler.decide(
            self.kv.free_slots, len(self._slot_req),
            has_partial=self._partial is not None,
            last_action=self._last_action)
        if action == "prefill":
            req = self.scheduler.pop()
            if req is not None:
                self._do_prefill(req)
        elif action == "prefill_chunk":
            self._do_prefill_chunk()
        elif action == "decode":
            self._do_decode()
        self._last_action = action
        return action

    # -- weight rollover ---------------------------------------------------
    def swap_params(self, params, version: Optional[int] = None) -> int:
        """Hot-swap the serving weights WITHOUT draining slots (call between
        ``step()`` calls); returns the new :attr:`weights_version`. Every
        decode round runs under one params dict, so each emitted token is
        attributable to exactly one version. In-flight requests keep their
        slots, carries and K/V. ``version`` stamps the new weights (default:
        previous + 1); a rollback republishes an older stamp."""
        self._check_params(params)
        self.params = params
        self.kv.set_params(params)
        self.weights_version = (self.weights_version + 1 if version is None
                                else int(version))
        self.metrics.observe_swap(self.weights_version)
        return self.weights_version

    # -- early termination ------------------------------------------------
    def cancel(self, request_id: str) -> bool:
        """Terminate a queued or in-flight request NOW: its slot (if any)
        is reclaimed in O(1) and a terminal record with
        ``finish_reason="cancelled"`` and the tokens so far is filed.
        Returns False for ids that are not live."""
        req = self._requests.get(request_id)
        if req is None:
            return False
        self._finish_early(req, "cancelled")
        return True

    def _shed_unmeetable(self) -> None:
        """Shed QUEUED requests that provably cannot meet their deadline
        (``"shed"``: dropped before they cost a slot)."""
        for req in self.scheduler.unmeetable(self.clock(),
                                             self.itl_estimate_s):
            self._finish_early(req, "shed")

    def _reap_expired(self) -> None:
        """Reap ADMITTED requests whose deadline passed (``"deadline"``)."""
        now = self.clock()
        for req in list(self._requests.values()):
            if (req.slot is not None and req.deadline_at is not None
                    and now >= req.deadline_at):
                self._finish_early(req, "deadline")

    def _finish_early(self, req: ServingRequest, reason: str) -> None:
        """Shared teardown for cancel/deadline/shed: release device + host
        state and file the terminal record."""
        if req.slot is None:
            self.scheduler.discard(req)
        else:
            slot = req.slot
            if req is self._partial:
                self._partial = None
            self._slot_req.pop(slot, None)
            self.kv.release(slot)
            self._park(slot)
        self._requests.pop(req.request_id, None)
        req.timing.finished_at = self.clock()
        req.timing.generated_tokens = len(req.generated)
        req.timing.finish_reason = reason
        self.metrics.observe_cancel(reason, tokens=len(req.generated))
        self._file_finished(self._terminal_record(req, reason))

    def drain(self, max_steps: Optional[int] = None
              ) -> Dict[str, FinishedRequest]:
        """Step until no request is queued or active (or ``max_steps``
        runs out); returns ALL finished requests so far by id."""
        steps = 0
        while self.scheduler.queue_depth or self.kv.active_slots:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self._finished)

    def result(self, request_id: str,
               pop: bool = True) -> Optional[FinishedRequest]:
        """Fetch (and by default REMOVE) a terminal record; ``pop=False``
        peeks."""
        if pop:
            return self._finished.pop(request_id, None)
        return self._finished.get(request_id)

    @staticmethod
    def _terminal_record(req: ServingRequest, reason: str) -> FinishedRequest:
        versions = list(req.token_versions)
        return FinishedRequest(
            request_id=req.request_id, prompt=req.prompt,
            tokens=list(req.generated), finish_reason=reason,
            timing=req.timing, token_versions=versions,
            version_first=versions[0] if versions else -1,
            version_last=versions[-1] if versions else -1)

    def _file_finished(self, fin: FinishedRequest) -> None:
        """Record a terminal request, evicting the OLDEST retained results
        past ``max_finished``."""
        self._finished[fin.request_id] = fin
        while len(self._finished) > self.max_finished:
            self._finished.pop(next(iter(self._finished)))
            self.metrics.observe_result_evicted()

    def snapshot(self) -> Dict[str, object]:
        """Engine + request metrics as one JSON-able dict."""
        return self.metrics.snapshot(
            active_slots=self.kv.active_slots,
            queue_depth=self.scheduler.queue_depth)

    # -- device step state -------------------------------------------------
    def _set_row(self, slot: int, tok: int, pos: int, temp: float,
                 seed: int, live: bool) -> None:
        """Write one row of the device step state (five small device
        writes, no host sync)."""
        self._tok[slot] = tok
        self._pos[slot] = pos
        self._temps[slot] = temp
        self._seeds[slot] = seed
        self._live[slot] = live

    def _park(self, slot: int) -> None:
        """Return a slot's row to the free-rider configuration: greedy
        no-op at position 0 whose output is ignored."""
        self._set_row(slot, 0, 0, 0.0, 0, False)

    # -- internals -------------------------------------------------------
    def _do_prefill(self, req: ServingRequest) -> None:
        slot = self.kv.allocate()
        req.timing.admitted_at = self.clock()
        req.slot = slot
        self.metrics.observe_prefill()
        T0 = int(req.prompt.shape[0])
        C = self.prefill_chunk
        if C is not None and T0 > C:
            # long prompt: open a chunk train — first chunk now, the rest
            # interleaved with decode by the scheduler
            self._partial = req
            self._do_prefill_chunk()
            return
        last = self.kv.insert(slot, req.prompt)
        self._start_decoding(req, last)

    def _do_prefill_chunk(self) -> None:
        """Advance the open chunk train by one chunk; the FINAL chunk's
        last real logits select the first token and the slot goes live."""
        req = self._partial
        T0 = int(req.prompt.shape[0])
        start = req.prefill_pos
        end = min(start + self.prefill_chunk, T0)
        t0 = self._perf()
        last = self.kv.insert(req.slot, req.prompt[start:end], pos0=start)
        _wait(last)
        self.metrics.observe_prefill_chunk(
            end - start, len(self._slot_req), self._perf() - t0)
        req.prefill_pos = end
        if end < T0:
            # park the row non-live AT THE WRITE HEAD: the garbage K/V an
            # interleaved decode step writes there lands exactly where the
            # next chunk's insert overwrites it
            self._set_row(req.slot, 0, end, 0.0, 0, False)
            return
        self._partial = None
        self._start_decoding(req, last)

    def _start_decoding(self, req: ServingRequest, last) -> None:
        """Select the first token from the prompt's last real logits, stamp
        timing, and make the slot a live decode row."""
        T0 = int(req.prompt.shape[0])
        dev = self.device
        tok = int(select_slot_tokens(
            last[None], torch.tensor([T0], device=dev),
            torch.tensor([req.temperature], device=dev),
            torch.tensor([req.seed], device=dev),
            sampled=req.temperature > 0)[0])
        req.timing.first_token_at = self.clock()
        self._slot_req[req.slot] = req
        self._set_row(req.slot, tok, T0, req.temperature, req.seed, True)
        self._emit(req, tok)

    def _fuse_window(self) -> int:
        """How many decode steps the next decode block may run before the
        host reads its tokens (1 = single step). Fusion is bypassed
        whenever it could change OBSERVABLE behavior beyond latency: an
        open chunk train, any live deadline, or — when work is queued —
        any active EOS-able request. The window is clamped to the smallest
        remaining token budget."""
        K = self.fuse_k
        if K < 2 or self._partial is not None or not self._slot_req:
            return 1
        if any(r.deadline_at is not None for r in self._requests.values()):
            return 1
        active = self._slot_req.values()
        if self.scheduler.queue_depth and any(
                r.eos_id is not None for r in active):
            return 1
        return max(1, min(K, min(r.max_new - len(r.generated)
                                 for r in active)))

    def _do_decode(self) -> None:
        K = self._fuse_window()
        n_active = len(self._slot_req)
        sampled = any(r.temperature > 0 for r in self._slot_req.values())
        t0 = self._perf()
        emit, self._tok, self._pos = _decode_block(
            self.model, self.params, self.kv.cache, self._tok, self._pos,
            self._temps, self._seeds, self._live, K, sampled)
        toks = emit.cpu().numpy()                    # [S, K]
        t1 = self._perf()
        for slot, req in list(self._slot_req.items()):
            # consume this row's tokens in order; stop at its finish — the
            # device kept decoding past it, but those writes are garbage
            # the staleness-repair invariant already covers
            for j in range(K):
                if req.request_id not in self._requests:
                    break
                self.kv.advance(slot)
                self._emit(req, int(toks[slot, j]))
        self.metrics.observe_decode_block(
            n_active, K, block_s=t1 - t0, host_s=self._perf() - t1)

    def _emit(self, req: ServingRequest, tok: int) -> None:
        """Deliver one generated token: record, stream, finish/continue."""
        req.generated.append(tok)
        req.token_versions.append(self.weights_version)
        done_eos = req.eos_id is not None and tok == req.eos_id
        done_len = len(req.generated) >= req.max_new
        done = done_eos or done_len
        if req.on_token is not None:
            req.on_token(req.request_id, tok, done)
        if not done:
            return   # the device carry already holds `tok`
        req.timing.finished_at = self.clock()
        req.timing.generated_tokens = len(req.generated)
        req.timing.finish_reason = "eos" if done_eos else "length"
        self.metrics.observe_finish(req.timing)
        self._file_finished(
            self._terminal_record(req, req.timing.finish_reason))
        slot = req.slot
        self._slot_req.pop(slot, None)
        self._requests.pop(req.request_id, None)
        self.kv.release(slot)
        self._park(slot)
