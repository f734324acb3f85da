"""Slot-based batched KV cache: the device state of the serving engine
(port of ``elephas_tpu/serving/cache.py``).

One fixed ``{"k"/"v": [L, S, Hkv, T, Dh]}`` buffer pair (the
:meth:`TransformerLM.init_cache` layout with batch = ``n_slots``) backs
every in-flight request: the BATCH axis is the SLOT axis. A request's
lifecycle against it:

1. **allocate** — pop a slot id off the free list (host bookkeeping only).
2. **prefill-insert** — run the prompt through
   :meth:`TransformerLM.prefill_slot` (a ``decode_chunk`` over just that
   slot's rows), which writes the prompt's K/V in place without touching
   any other slot. Prompts are right-padded to a power-of-two bucket as in
   the reference, so the port writes the same positions and has few
   distinct shapes; pad K/V is harmless by the staleness-repair invariant
   (every pad position is overwritten by this request's own decode writes
   before any of its queries attend it) and the first token is read from
   the REAL last row of the logits.
3. **decode in place** — the engine's batched ``decode_step`` advances all
   active slots with per-row positions; this module only tracks where each
   slot's write head is.
4. **release** — push the slot id back on the free list. No device work:
   the stale K/V left behind is dead by construction, which is what makes
   slot reclaim O(1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.transformer import select_slot_tokens, spec_verify_select


def bucket_length(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= ``n`` (and >= ``minimum``): the prompt pad
    target."""
    b = max(int(minimum), 1)
    while b < n:
        b *= 2
    return b


def decode_block(step, params, cache, tokens, pos, temps, seeds, live,
                 n_steps: int, sampled: bool):
    """``n_steps`` batched decode steps over every slot, each with per-slot
    selection: ``step(params, tokens, pos, cache) -> (logits, cache)`` is the
    model's one-token step over the engine's KV state (dense or paged);
    ``tokens``/``pos``/``temps``/``seeds``/``live`` ``[S]`` → ``(emitted [S,
    n_steps], tokens, pos)``. Live rows advance their carry token and
    position on the device; non-live rows neither advance nor change their
    carry (their emitted entries are garbage the host ignores). The cache is
    written in place. Rows are independent and selection is ``(seed,
    position)``-keyed, so ``n_steps`` steps here emit exactly what
    ``n_steps`` single-step calls would."""
    emitted = []
    for _ in range(n_steps):
        logits, cache = step(params, tokens, pos, cache)
        emit = select_slot_tokens(logits, pos + 1, temps, seeds, sampled)
        tokens = torch.where(live, emit, tokens)
        pos = torch.where(live, pos + 1, pos)
        emitted.append(emit)
    return torch.stack(emitted, dim=1), tokens, pos


def spec_commit(logits, drafts, tokens, pos, temps, seeds, live,
                sampled: bool):
    """The accept half of a speculative verify, shared by the dense and the
    paged engine: ``logits`` ``[S, W+1, V]`` of the chunk carry ++
    ``drafts`` → ``(sel [S, W+1], n_accepted [S], tokens, pos)``, live rows
    advanced past their accepted run and correction ``sel[:, n]`` on the
    device (:func:`~elephas_tpu_torch.models.transformer.
    spec_verify_select`)."""
    sel, n = spec_verify_select(logits, drafts, pos, temps, seeds, sampled)
    corr = sel.gather(1, n[:, None])[:, 0]
    return (sel, n, torch.where(live, corr, tokens),
            torch.where(live, pos + n + 1, pos).to(pos.dtype))


class SlotKVCache:
    """Free-list + per-slot write-head bookkeeping over one batched KV
    buffer on the model's device, ``aligned_cache_length(max_len)`` slots
    long (via ``init_cache``). ``capacity`` overrides the cache time axis
    (an already-aligned total); ``cache`` hands in a buffer made elsewhere,
    as the reference's sharded engine does."""

    def __init__(self, model, params, n_slots: int,
                 max_len: Optional[int] = None,
                 capacity: Optional[int] = None,
                 cache: Optional[Dict[str, Any]] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if model._ring_cache:
            raise NotImplementedError(
                "SlotKVCache needs a linear (horizon) cache; all-windowed "
                "models allocate rolling buffers (see "
                "TransformerLM.prefill_slot)")
        self.model = model
        self.params = params
        self.n_slots = int(n_slots)
        self.max_len = int(model.max_len if max_len is None else max_len)
        if self.max_len > model.max_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's {model.max_len}")
        if cache is not None:
            self.cache = cache
        else:
            self.cache = model.init_cache(self.n_slots,
                                          length=capacity or self.max_len)
        self.capacity = int(self.cache["k"].shape[3])
        if self.max_len > self.capacity:
            raise ValueError(f"max_len {self.max_len} exceeds cache capacity "
                             f"{self.capacity}")
        self._free: List[int] = list(range(self.n_slots - 1, -1, -1))
        # write head per slot: the absolute position the NEXT write lands
        # at (prompt length after insert; +1 per decode step)
        self.pos = np.zeros(self.n_slots, np.int32)

    # -- slot accounting -------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.n_slots - len(self._free)

    def allocate(self) -> int:
        if not self._free:
            raise RuntimeError("no free slot (caller must check free_slots)")
        return self._free.pop()

    def release(self, slot: int) -> None:
        if slot in self._free or not 0 <= slot < self.n_slots:
            raise ValueError(f"bad release of slot {slot}")
        self.pos[slot] = 0
        self._free.append(slot)

    def set_params(self, params) -> None:
        """Swap the weights future PREFILL INSERTS run under (decode steps
        take params from the engine per launch)."""
        self.params = params

    # -- device ops ------------------------------------------------------
    def insert(self, slot: int, prompt: np.ndarray,
               pos0: int = 0) -> torch.Tensor:
        """Prefill ``prompt`` ``[T0]`` int into ``slot`` at positions
        ``pos0..pos0+T0-1``, in place; returns the logits of the last REAL
        prompt position ``[V]`` on the device (what the first generated
        token is selected from). ``pos0 > 0`` is a chunked-prefill
        continuation: the chunk attends everything this slot already
        holds."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        T0 = prompt.shape[0]
        pos0 = int(pos0)
        if not 1 <= T0 <= self.max_len:
            raise ValueError(f"prompt length {T0} not in [1, {self.max_len}]")
        if not 0 <= pos0 <= self.max_len - T0:
            raise ValueError(
                f"pos0 {pos0} + chunk {T0} exceeds max_len {self.max_len}")
        # bucket-pad, but never let the padded span run off the cache end
        Tb = min(bucket_length(T0), self.capacity - pos0)
        padded = np.zeros((1, Tb), np.int64)
        padded[0, :T0] = prompt
        tokens = torch.from_numpy(padded).to(self.model.device)
        logits, self.cache = self.model.prefill_slot(
            self.params, tokens, slot, self.cache, pos0=pos0)
        self.pos[slot] = pos0 + T0
        return logits[0, T0 - 1]

    def advance(self, slot: int) -> None:
        """Record one decode-step write for ``slot``."""
        self.pos[slot] += 1

    def remaining(self, slot: int) -> int:
        """Positions ``slot`` can still write: ``max_len - pos[slot]`` (the
        host's write head, no device read)."""
        return self.max_len - int(self.pos[slot])
