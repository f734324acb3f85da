"""The continuous-batching serving loop (port of the local dense and paged
paths of ``elephas_tpu/serving/engine.py``).

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

``paged=True`` swaps the dense slot cache for the paged pool
(:class:`~elephas_tpu_torch.serving.memory.PagedKVCache`): KV memory scales
with live tokens, a radix prefix cache lets requests with a shared prompt
prefix adopt its pages and skip their prefill, and admission gates on free
pages. Under page pressure the engine evicts clean prefix pages, then
preempts the newest request, which later resumes from prompt ++ generated
with an unchanged token stream. The paged engine emits exactly the dense
engine's tokens on the CPU. It is also the multi-tenant engine: over a
:class:`~elephas_tpu_torch.models.lora.MultiTenantLM`, ``submit(...,
adapter_id=)`` serves each request under its LoRA adapter, co-batched with
every other tenant (adapter 0 is the base model; the dense engine serves
adapter 0 only).

Speculative decoding (``speculate_k=``): a drafter proposes up to
``speculate_k - 1`` tokens per live slot (:class:`NgramDrafter` on the
host, or :class:`ModelDrafter`'s greedy rollouts on its own dense slot
cache), then ONE verify forward scores the carry and the drafts as a chunk
(``decode_chunk``, or ``decode_chunk_paged`` through the block table) and
accepts each row's longest prefix that matches what the sequential engine
would emit: the same ``(seed, position)``-keyed selection at every chunk
offset (:func:`~elephas_tpu_torch.models.transformer.spec_verify_select`).
Up to ``speculate_k`` tokens commit per round and the stream is the
``speculate_k=1`` stream, greedy and sampled, bit for bit on the CPU; on
the card the chunk and the step attend through other kernels, so there the
two agree up to near ties. Speculation stands down to the sequential step
on the conditions that stop fusion, and while a :class:`ModelDrafter`'s
weights are stale. A :class:`ModelDrafter` over a ``MultiTenantLM`` drafts
each row under the row's adapter. Meshes and fault injection are later
slices of the port and raise ``NotImplementedError``.

Time is injectable (``clock=``): latency tests pin exact TTFT/queue-wait
numbers with a fake clock. The latency histograms read a separate
``perf_clock`` (``time.perf_counter`` by default).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..models.transformer import _adapter_ctx, select_slot_tokens
from .cache import SlotKVCache, bucket_length, decode_block, spec_commit
from .memory import PagedKVCache, PagesExhausted
from .metrics import RequestTiming, ServingMetrics
from .scheduler import AdmissionError, Scheduler, ServingRequest


def _wait(t: torch.Tensor) -> None:
    """Block until the work producing ``t`` has finished on its device."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _verify(model, params, cache, drafts, tokens, pos, temps, seeds, live,
            sampled: bool):
    """The dense speculative verify over every slot (the reference's
    ``_verify_kernel``): score the carry and ``W`` drafts as ONE
    ``decode_chunk`` (each row's chunk at its own ``pos``), select what the
    sequential engine would emit at all ``W + 1`` offsets, and advance live
    rows past their accepted run and correction on the device → ``(sel [S,
    W+1], n_accepted [S], tokens, pos)``. The chunk's K/V land at
    ``pos..pos+W`` in place; the rejected tail is stale-dead (the next
    round's chunk starts at ``pos + n + 1`` and rewrites it before anything
    attends it)."""
    chunk = torch.cat([tokens[:, None], drafts], dim=1)
    logits, _ = model.decode_chunk(params, chunk, pos, cache)
    return spec_commit(logits, drafts, tokens, pos, temps, seeds, live,
                       sampled)


def _draft_propose(model, params, cache, tokens, pos, live, aids,
                   n_steps: int):
    """Greedy draft rollout on the draft model's own dense slot cache:
    ``n_steps`` decode steps from the target's carry and position (the
    draft's write head equals the target's committed head at round start),
    each row under its adapter ``aids`` (a multi-tenant draft model; a
    plain one ignores them), argmax proposals ``[S, n_steps]``, then one
    more step that ingests the last proposal at ``pos + n_steps`` (its
    logits unused). Without it a fully accepted round would leave that
    position a hole in the draft cache, corrupting every later proposal of
    the row; the reference's engine leaves the hole (acceptance, never
    tokens, pays for it), its ``generate_speculative`` ingests as here.
    Rows written past this round's accepted prefix are rewritten by the
    next rollout before anything attends them. Greedy keeps the proposer a
    delta distribution, which the exact-match acceptance needs."""
    drafts = []
    with _adapter_ctx(model, aids):
        for _ in range(n_steps):
            logits, cache = model.decode_step(params, tokens, pos, cache)
            nxt = logits.argmax(dim=-1)
            tokens = torch.where(live, nxt, tokens)
            pos = torch.where(live, pos + 1, pos)
            drafts.append(nxt)
        model.decode_step(params, tokens, pos, cache)
    return torch.stack(drafts, dim=1)


class NgramDrafter:
    """Self-drafting prompt-lookup proposer (host-side, deterministic, no
    parameters), a copy of the reference's: propose the ``k`` tokens that
    FOLLOWED the most recent earlier occurrence of the context's trailing
    n-gram (longest ``n`` first), else repeat the last token. Low
    acceptance costs chunk width, never tokens: the verify rule is exact
    under any deterministic proposer."""

    def __init__(self, n_max: int = 3):
        if n_max < 1:
            raise ValueError(f"n_max must be >= 1, got {n_max}")
        self.n_max = int(n_max)

    def propose(self, context, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32).reshape(-1)
        T = ctx.shape[0]
        out = np.full(k, int(ctx[-1]) if T else 0, np.int32)
        for n in range(min(self.n_max, T - 1), 0, -1):
            pat = ctx[T - n:]
            wins = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.nonzero((wins == pat[None, :]).all(axis=1))[0]
            if hits.size:
                s = int(hits[-1])
                cont = ctx[s + n: s + n + k]
                out[:cont.size] = cont
                out[cont.size:] = int(cont[-1])
                return out
        return out


class ModelDrafter:
    """Draft-transformer proposer: greedy rollouts from a small model on its
    OWN dense slot cache (engine-managed), prefilled at admission and
    advanced in lockstep with the target's committed stream. Local engines
    only, dense or paged. Pass a
    :class:`~elephas_tpu_torch.models.lora.MultiTenantLM` to draft per
    adapter: each row's prefill and rollout run under the row's adapter (an
    id past the drafter's ``n_adapters`` drafts with adapter 0). A plain
    draft model drafts every tenant with its base weights; acceptance may
    drop for adapted rows, the tokens never depend on the proposer.
    ``steps`` and ``prefills`` count the batched draft decode steps (``W +
    1`` for a round of ``W`` drafts) and the slot inserts the engine ran on
    it, each one launch of every kernel on the draft model's path."""

    def __init__(self, model, params):
        if getattr(model, "_ring_cache", False):
            raise NotImplementedError(
                "draft model must use a linear (horizon) cache — windowed "
                "models roll their buffers in prefill_slot")
        self.model = model
        self.params = params
        self.steps = 0
        self.prefills = 0


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
                 fuse_k: int = 1, paged: bool = False, page_size: int = 16,
                 pages_per_partition: Optional[int] = None,
                 prefix_cache: bool = True, speculate_k: int = 1,
                 drafter=None,
                 perf_clock: Callable[[], float] = time.perf_counter,
                 itl_estimate_s: Optional[float] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (ROADMAP.md queue 1 item 6, "
                "second half, 'Speculation and sharding')")
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
        if speculate_k > 1 and getattr(model, "n_experts", 0):
            raise ValueError(
                "speculate_k > 1 needs a dense-FFN target: the verify chunk "
                "re-groups MoE expert dispatch, which breaks the bitwise pin "
                "against sequential decode")
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
        self.metrics = ServingMetrics(n_slots=n_slots, window=metrics_window,
                                      spec_k=int(speculate_k))
        self._paged = bool(paged)
        if self._paged:
            # the pool and block tables live in PagedKVCache, which speaks
            # the insert/decode surface the loop below drives
            self.kv = PagedKVCache(
                model, params, n_slots, max_len=max_len, page_size=page_size,
                pages_per_partition=pages_per_partition,
                prefix_cache=prefix_cache)
            self._decode_block = self.kv.fused_fn
            self._verify_fn = self.kv.verify_fn
        else:
            self.kv = SlotKVCache(model, params, n_slots, max_len=max_len)
            self._decode_block = partial(decode_block, model.decode_step)
            self._verify_fn = partial(_verify, model)
        # per-slot step state, DEVICE-resident: the decode step advances it;
        # the host writes single rows at admission/release
        S, dev = self.kv.n_slots, self.device
        self._tok = torch.zeros(S, dtype=torch.int64, device=dev)    # carry
        self._pos = torch.zeros(S, dtype=torch.int32, device=dev)    # write head
        self._temps = torch.zeros(S, dtype=torch.float32, device=dev)  # <=0 greedy
        self._seeds = torch.zeros(S, dtype=torch.int64, device=dev)
        self._live = torch.zeros(S, dtype=torch.bool, device=dev)
        # speculative decoding (speculate_k >= 2): the drafter and, for a
        # model drafter, its own dense slot cache, advanced in lockstep with
        # the target's committed stream
        self.speculate_k = int(speculate_k)
        self.drafter = None
        self._draft_cache = None
        if self.speculate_k > 1:
            self.drafter = NgramDrafter() if drafter is None else drafter
            if isinstance(self.drafter, ModelDrafter):
                self._draft_cache = self.drafter.model.init_cache(
                    S, self.kv.max_len)
                # each row's adapter on the draft model, written at the
                # row's draft prefill
                self._draft_aids = torch.zeros(S, dtype=torch.int64, device=dev)
        self.weights_version = 0
        # a ModelDrafter whose params were not swapped with the target's
        # stands down until fresh drafter params arrive
        self._drafter_stale = False
        self._partial: Optional[ServingRequest] = None  # open chunk train
        self._last_action: Optional[str] = None
        self._slot_req: Dict[int, ServingRequest] = {}
        self._requests: Dict[str, ServingRequest] = {}
        self._finished: Dict[str, FinishedRequest] = {}
        self._next_id = 0
        self._admit_seq = itertools.count()  # preemption recency order

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
               deadline_s: Optional[float] = None,
               adapter_id: int = 0) -> str:
        """Enqueue one generation request; returns its id. Raises
        :class:`AdmissionError` (with a machine-readable ``.reason``) on
        validation failure or queue backpressure — rejected work never
        holds a queue entry or a slot. ``deadline_s`` bounds the request's
        whole lifetime from submit: once exceeded it is reaped at the next
        ``step()`` with ``finish_reason="deadline"`` and whatever tokens it
        produced. ``adapter_id`` selects the request's LoRA variant on a
        paged engine serving a
        :class:`~elephas_tpu_torch.models.lora.MultiTenantLM` (0 = the base
        model everywhere)."""
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
            n_adapters = int(getattr(self.model, "n_adapters", 1))
            if adapter_id != 0 and not self._paged:
                raise AdmissionError(
                    "bad_request",
                    f"adapter_id {adapter_id}: non-zero adapters need the "
                    f"paged engine (paged=True)")
            if not 0 <= adapter_id < n_adapters:
                raise AdmissionError(
                    "bad_request",
                    f"adapter_id {adapter_id} not in [0, {n_adapters})")
            if self._paged and not self.kv.fits(T0 + int(max_new)):
                raise AdmissionError(
                    "length_exceeds_cache",
                    f"prompt {T0} + max_new {max_new} cannot fit the page "
                    f"pool even alone ({self.kv.pages_per_partition - 1} "
                    f"usable pages of {self.kv.page} tokens)")
            submitted_at = self.clock()
            req = ServingRequest(
                request_id=rid, prompt=prompt, max_new=int(max_new),
                temperature=float(temperature), eos_id=eos_id,
                priority=int(priority), seed=int(seed), on_token=on_token,
                adapter_id=int(adapter_id),
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
        self.metrics.observe_submit(req.adapter_id)
        return rid

    # -- the loop --------------------------------------------------------
    def step(self) -> str:
        """Run ONE scheduler action — ``"prefill"``, ``"prefill_chunk"``,
        ``"decode"`` or ``"idle"`` — and return which one ran. Expired
        deadlines are reaped first, so a timed-out request frees its slot
        before this step's work is chosen."""
        self._shed_unmeetable()
        self._reap_expired()
        free_pages, need_pages = self._admission_budget()
        action = self.scheduler.decide(
            self.kv.free_slots, len(self._slot_req),
            has_partial=self._partial is not None,
            last_action=self._last_action,
            free_pages=free_pages, need_pages=need_pages,
            reserve_pages=(self._spec_reserve_pages()
                           if free_pages is not None else 0))
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

    def _admission_budget(self):
        """``(free_pages, need_pages)`` for the queue HEAD on the paged
        engine — what :meth:`Scheduler.decide` gates admission on —
        ``(None, None)`` whenever pages are not the binding constraint
        (dense engine, empty queue, no free slot, open chunk train). The
        need counts only pages beyond the prefix cached for the head's
        adapter, and the check may evict clean prefix pages to make room."""
        if (not self._paged or self._partial is not None
                or not self.scheduler.queue_depth
                or self.kv.free_slots == 0):
            return None, None
        head = self.scheduler.peek()
        if head is None:
            return None, None
        # one device: every slot is on data rank 0
        return self.kv.admission_check(self._req_prompt(head),
                                       head.adapter_id, 0)

    def _spec_reserve_pages(self) -> int:
        """Pages the live slots' speculative lookahead may still claim: a
        verify round writes ``pos..pos+speculate_k-1`` per active slot, so
        admission leaves those pages claimable (the pre-launch
        evict/preempt recovery cannot help once the verify has run). Counts
        not-yet-owned pages over the active slots from the host's write
        heads and page maps: no device read."""
        if self.speculate_k < 2 or not self._slot_req:
            return 0
        page, need = self.kv.page, 0
        for slot in self._slot_req:
            p = int(self.kv.pos[slot])
            lo = p // page
            hi = min((p + self.speculate_k - 1) // page, self.kv.M - 1)
            owned = self.kv.owned[slot]
            need += sum(1 for m in range(lo, hi + 1) if m not in owned)
        return need

    # -- weight rollover ---------------------------------------------------
    def swap_params(self, params, version: Optional[int] = None,
                    drafter_params=None) -> int:
        """Hot-swap the serving weights WITHOUT draining slots (call between
        ``step()`` calls); returns the new :attr:`weights_version`. Every
        decode round runs under one params dict, so each emitted token is
        attributable to exactly one version. In-flight requests keep their
        slots, carries and K/V. ``version`` stamps the new weights (default:
        previous + 1); a rollback republishes an older stamp. On the paged
        engine the prefix cache is flushed (its pages hold K/V computed
        under the old weights); live slots keep their own page references.

        With a :class:`ModelDrafter`, ``drafter_params`` swaps the drafter
        atomically with the target; without it the drafter STANDS DOWN (the
        engine decodes sequentially, the same tokens) until a later swap
        brings fresh drafter params. A host drafter has no weights and
        keeps speculating. ``drafter_params`` without a ``ModelDrafter``
        raises ``ValueError``."""
        if drafter_params is not None and not isinstance(self.drafter,
                                                         ModelDrafter):
            raise ValueError(
                "drafter_params passed but the engine has no ModelDrafter "
                "to swap them into")
        self._check_params(params)
        self.params = params
        self.kv.set_params(params)
        if isinstance(self.drafter, ModelDrafter):
            if drafter_params is not None:
                # the draft cache's old K/V only dents acceptance (the
                # verify is exact); the next rollout rewrites its frontier
                self.drafter.params = drafter_params
                self._drafter_stale = False
            else:
                self._drafter_stale = True
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
        self.metrics.observe_cancel(reason, adapter_id=req.adapter_id,
                                    tokens=len(req.generated))
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
        """Engine + request metrics as one JSON-able dict; on the paged
        engine a ``"memory"`` section reports page utilization, pool bytes,
        preemptions and the prefix-cache hit ratio."""
        return self.metrics.snapshot(
            active_slots=self.kv.active_slots,
            queue_depth=self.scheduler.queue_depth,
            memory=self.kv.memory_stats() if self._paged else None)

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
    @staticmethod
    def _req_prompt(req: ServingRequest) -> np.ndarray:
        """The tokens this admission must prefill: the original prompt, or,
        after a preemption, prompt ++ already-generated (selection is
        ``(seed, position)``-keyed, so the resumed stream is unchanged)."""
        return req.prompt if req.resume_prompt is None else req.resume_prompt

    def _do_prefill(self, req: ServingRequest) -> None:
        slot = self.kv.allocate()
        req.timing.admitted_at = self.clock()
        req.slot = slot
        req.prefill_version = self.weights_version
        req.prefill_pos = 0
        self.metrics.observe_prefill(req.adapter_id)
        prompt = self._req_prompt(req)
        T0 = int(prompt.shape[0])
        if self._paged:
            # the adapter keys the prefix tree: set before adoption (and
            # again on a preempted request's re-admission)
            self.kv.set_adapter(slot, req.adapter_id)
            req.admit_seq = next(self._admit_seq)
            # prefix-cache hit: adopted pages skip their prefill outright
            req.prefill_pos = self.kv.adopt_prefix(slot, prompt)
        C = self.prefill_chunk
        if C is not None and T0 - req.prefill_pos > C:
            # long prompt: open a chunk train — first chunk now, the rest
            # interleaved with decode by the scheduler
            self._partial = req
            self._do_prefill_chunk()
            return
        last = self._insert_guarded(req, prompt[req.prefill_pos:],
                                    req.prefill_pos)
        self._start_decoding(req, last)

    def _do_prefill_chunk(self) -> None:
        """Advance the open chunk train by one chunk; the FINAL chunk's
        last real logits select the first token and the slot goes live."""
        req = self._partial
        prompt = self._req_prompt(req)
        T0 = int(prompt.shape[0])
        start = req.prefill_pos
        end = min(start + self.prefill_chunk, T0)
        t0 = self._perf()
        last = self._insert_guarded(req, prompt[start:end], start)
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
        prompt = self._req_prompt(req)
        T0 = int(prompt.shape[0])
        dev = self.device
        tok = int(select_slot_tokens(
            last[None], torch.tensor([T0], device=dev),
            torch.tensor([req.temperature], device=dev),
            torch.tensor([req.seed], device=dev),
            sampled=req.temperature > 0)[0])
        if req.timing.first_token_at is None:   # a resume keeps its TTFT
            req.timing.first_token_at = self.clock()
        if self._paged and req.prefill_version == self.weights_version:
            # publish the complete prompt pages for later prefix hits; a
            # chunked prefill that spanned a swap holds mixed-version K/V
            # and is left out
            self.kv.register_prefix(req.slot, prompt)
        if isinstance(self.drafter, ModelDrafter):
            self._draft_prefill(req)
        self._slot_req[req.slot] = req
        self._set_row(req.slot, tok, T0, req.temperature, req.seed, True)
        self._emit(req, tok)

    def _draft_prefill(self, req: ServingRequest) -> None:
        """(Re)prefill the draft model's slot row with the request's whole
        prompt (prompt ++ generated after a preemption), so the draft cache
        agrees with the target's committed stream before its first
        rollout: one bucket-padded insert, never chunked, under the row's
        adapter (0 when the draft model has fewer adapters)."""
        prompt = self._req_prompt(req)
        dm = self.drafter
        T0 = int(prompt.shape[0])
        Tb = min(bucket_length(T0), int(self._draft_cache["k"].shape[3]))
        padded = np.zeros((1, Tb), np.int64)
        padded[0, :T0] = prompt
        aid = (req.adapter_id
               if req.adapter_id < int(getattr(dm.model, "n_adapters", 1))
               else 0)
        self._draft_aids[req.slot] = aid
        with _adapter_ctx(dm.model, self._draft_aids[req.slot:req.slot + 1]):
            dm.model.prefill_slot(dm.params,
                                  torch.from_numpy(padded).to(self.device),
                                  req.slot, self._draft_cache)
        dm.prefills += 1

    # -- page pressure (paged engine only) --------------------------------
    def _insert_guarded(self, req: ServingRequest, chunk, pos0: int):
        """``kv.insert`` with page-pressure recovery: on
        :class:`PagesExhausted`, evict clean prefix pages — failing that,
        preempt the newest other request — and retry. A request alone
        always fits (``kv.fits`` is checked at submit), so the loop ends."""
        while True:
            try:
                return self.kv.insert(req.slot, chunk, pos0=pos0)
            except PagesExhausted as e:
                self._relieve_pressure(e, exclude=req)

    def _ensure_decode_guarded(self, n_steps: int) -> None:
        """Allocate the pages the next decode block will write, with the
        same evict-then-preempt recovery as inserts."""
        while True:
            try:
                self.kv.ensure_decode(list(self._slot_req), n_steps)
                return
            except PagesExhausted as e:
                self._relieve_pressure(e)

    def _relieve_pressure(self, exc: PagesExhausted,
                          exclude: Optional[ServingRequest] = None) -> None:
        """Free pages: clean (cache-only) prefix pages first, else preempt
        the newest request. Raises ``exc`` when neither is possible —
        unreachable while the submit-time ``fits`` invariant holds."""
        if self.kv.evict_pages(exc.partition, exc.shortfall) >= exc.shortfall:
            return
        cands = [r for r in self._slot_req.values() if r is not exclude]
        if self._partial is not None and self._partial is not exclude:
            cands.append(self._partial)
        if not cands:
            raise exc
        # LIFO: the oldest admitted work is the last to lose its slot
        self._preempt(max(cands, key=lambda r: r.admit_seq))

    def _preempt(self, victim: ServingRequest) -> None:
        """Evict a live request under page pressure: return every page it
        holds, park its row, and requeue it at the FRONT of its priority
        class. On re-admission it prefills prompt ++ generated-so-far and
        continues its exact token stream — preemption is invisible in the
        output."""
        slot = victim.slot
        if victim is self._partial:
            self._partial = None
        self._slot_req.pop(slot, None)
        self.kv.release(slot)
        self._park(slot)
        # always original prompt ++ ALL generated (not _req_prompt: a
        # second preemption must not re-append tokens already folded in)
        victim.resume_prompt = np.concatenate(
            [np.asarray(victim.prompt, np.int32),
             np.asarray(victim.generated, np.int32)])
        victim.slot = None
        victim.prefill_pos = 0
        victim.preemptions += 1
        self.kv.preemptions += 1
        self.scheduler.requeue(victim)

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

    def _spec_window(self) -> int:
        """How many tokens the next decode action may DRAFT (0 = stand down
        to sequential steps): 0 on the conditions that stop fusion (an
        open chunk train, any live deadline, queued work behind an
        EOS-able active request) and while a model drafter is stale; else
        the smallest remaining budget minus one (a verify emits up to
        ``drafts + 1``), capped at ``speculate_k - 1``. The clamp also keeps
        every chunk write inside the cache (``pos + W <= capacity - 1``),
        which ``decode_chunk``'s in-place row update requires."""
        K = self.speculate_k
        if (K < 2 or self._drafter_stale or self._partial is not None
                or not self._slot_req):
            return 0
        if any(r.deadline_at is not None for r in self._requests.values()):
            return 0
        active = self._slot_req.values()
        if self.scheduler.queue_depth and any(
                r.eos_id is not None for r in active):
            return 0
        return min(K - 1, min(r.max_new - len(r.generated)
                              for r in active) - 1)

    def _draft_tokens(self, W: int) -> torch.Tensor:
        """``[S, W]`` int64 proposals for this round's verify chunk (free
        rows get zeros, their chunk rows are dead). A model drafter rolls
        out on the device from the target's carry and positions; a host
        drafter (``propose(context, k)``) sees each request's prompt ++
        generated stream, whose last token is the carry."""
        if isinstance(self.drafter, ModelDrafter):
            d = self.drafter
            d.steps += W + 1
            return _draft_propose(d.model, d.params, self._draft_cache,
                                  self._tok, self._pos, self._live,
                                  self._draft_aids, W)
        out = np.zeros((self.kv.n_slots, W), np.int64)
        for slot, req in self._slot_req.items():
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.generated, np.int32)])
            out[slot] = self.drafter.propose(ctx, W)
        return torch.from_numpy(out).to(self.device)

    def _do_decode_spec(self, W: int) -> None:
        """One speculative round: draft ``W`` tokens per live slot, score
        the carry and drafts in ONE verify, and commit each row's accepted
        run and correction. The host reads ``sel`` and ``n_acc`` in one
        copy. Metrics count device-committed tokens (``n_accepted +
        n_active``); like the fused path, the host stops delivering a row's
        run at its EOS or budget, and the leftover device writes are
        stale-dead."""
        if self._paged:
            # every position the chunk writes (pos..pos+W) gets its page
            # BEFORE the launch, so the commit cannot fail (may evict or
            # preempt under pressure)
            self._ensure_decode_guarded(W + 1)
            if not self._slot_req:
                return
        n_active = len(self._slot_req)
        sampled = any(r.temperature > 0 for r in self._slot_req.values())
        t0 = self._perf()
        drafts = self._draft_tokens(W)
        sel, n_acc, self._tok, self._pos = self._verify_fn(
            self.params, self.kv.cache, drafts, self._tok, self._pos,
            self._temps, self._seeds, self._live, sampled)
        got = torch.cat([sel, n_acc[:, None]], dim=1).cpu().numpy()
        t1 = self._perf()
        act = list(self._slot_req.items())
        accepted = sum(int(got[slot, -1]) for slot, _ in act)
        for slot, req in act:
            for j in range(int(got[slot, -1]) + 1):
                if req.request_id not in self._requests:
                    break
                # the verify chunk wrote this token's K/V at its position
                self.kv.advance(slot)
                self._emit(req, int(got[slot, j]))
        self.metrics.observe_spec_round(
            n_active, n_drafted=n_active * W, n_accepted=accepted,
            n_emitted=accepted + n_active, block_s=t1 - t0,
            host_s=self._perf() - t1)

    def _do_decode(self) -> None:
        W = self._spec_window()
        if W > 0:
            self._do_decode_spec(W)
            return
        K = self._fuse_window()
        if self._paged:
            # decode writes land in allocated pages only: grow each active
            # slot's tail first (may evict or preempt under pressure)
            self._ensure_decode_guarded(K)
            if not self._slot_req:
                return
        n_active = len(self._slot_req)
        sampled = any(r.temperature > 0 for r in self._slot_req.values())
        t0 = self._perf()
        emit, self._tok, self._pos = self._decode_block(
            self.params, self.kv.cache, self._tok, self._pos,
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
        self.metrics.observe_finish(req.timing, adapter_id=req.adapter_id)
        self._file_finished(
            self._terminal_record(req, req.timing.finish_reason))
        slot = req.slot
        self._slot_req.pop(slot, None)
        self._requests.pop(req.request_id, None)
        self.kv.release(slot)
        self._park(slot)
