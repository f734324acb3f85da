"""Paged serving memory: block allocator, radix prefix cache, paged KV
(port of the local path of ``elephas_tpu/serving/memory.py``).

The dense :class:`~elephas_tpu_torch.serving.cache.SlotKVCache` pins
``slots × capacity`` KV rows on the device whether or not anyone uses
them. This module replaces that with a paged layout:

* **Physical pool** ``{"k"/"v": [L, P, Hkv, page, Dh]}`` — ``P`` fixed-size
  pages. Page 0 is the **trash page**: its refcount is pinned to 1,
  unallocated block-table cells point at it, and dead or parked rows'
  garbage writes land there.
* **Block tables** ``[S, M]`` int32 — per-slot maps from logical page index
  to physical page id. Attention reads through the table directly
  (``TransformerLM.decode_step_paged`` / ``decode_chunk_paged``, the
  paged-attention kernels on the card), and each layer writes only the
  newly produced rows into their owning pages. On the CPU the plain path
  gathers a transient per-slot view whose time axis equals the dense
  capacity and applies the dense attention math, so paged and dense are
  bitwise equal there; that is why ``page`` must divide the capacity.
* **Refcounts + radix prefix cache** — full prompt pages are registered in
  a radix tree keyed on their token content at page granularity. A later
  request with the same prefix *adopts* the cached pages (an incref: it
  skips their prefill) and shares them copy-on-write: divergence lands in
  a fresh tail page. Sharing is sound because a page's K/V content is a
  pure function of the token prefix (per weights version and adapter).
* **Adapters** — each slot carries an adapter id (:meth:`PagedKVCache.
  set_adapter`); a :class:`~elephas_tpu_torch.models.lora.MultiTenantLM`
  applies each row's LoRA delta inside every insert, decode and verify
  launch, and the prefix tree keeps one root per adapter, since an
  adapter changes the K/V a prompt writes.

Host bookkeeping (refcounts, tables, radix tree) is pure Python, copied
from the reference. The device block table and adapter ids are resident:
dirty slot rows are patched with one small upload, never a whole-table
upload. Meshes (several partitions) are a later slice of the port.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, FrozenSet, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import _adapter_ctx
from ..ops.flash_decode import aligned_cache_length
from .cache import bucket_length, decode_block, spec_commit


class PagesExhausted(RuntimeError):
    """A partition's free list ran dry mid-allocation. The engine reacts
    by evicting clean prefix pages and, failing that, preempting the
    newest request; ``partition``/``shortfall`` say where and how much."""

    def __init__(self, partition: int, shortfall: int):
        super().__init__(
            f"partition {partition} out of KV pages (short {shortfall})")
        self.partition = int(partition)
        self.shortfall = int(shortfall)


class BlockAllocator:
    """Refcounted fixed-size page allocator, one free list per partition.

    Page id 0 of every partition is the trash page: refcount pinned to 1,
    never allocated, never freed. All other pages cycle alloc → incref*
    → decref* → free. :meth:`check` asserts the full invariant set and is
    cheap enough to run after every operation in the fuzz tests.
    """

    def __init__(self, n_partitions: int, pages_per_partition: int):
        if n_partitions < 1 or pages_per_partition < 2:
            raise ValueError(
                f"need >=1 partition and >=2 pages/partition (trash + 1), "
                f"got {n_partitions} x {pages_per_partition}")
        self.n_partitions = int(n_partitions)
        self.pages_per_partition = int(pages_per_partition)
        P = self.pages_per_partition
        self._refs: List[List[int]] = [[0] * P
                                       for _ in range(self.n_partitions)]
        self._free: List[List[int]] = [list(range(P - 1, 0, -1))
                                       for _ in range(self.n_partitions)]
        for part in range(self.n_partitions):
            self._refs[part][0] = 1     # trash page, pinned

    def alloc(self, partition: int) -> int:
        """Pop a free page (refcount 1) or raise :class:`PagesExhausted`."""
        free = self._free[partition]
        if not free:
            raise PagesExhausted(partition, 1)
        lid = free.pop()
        self._refs[partition][lid] = 1
        return lid

    def incref(self, partition: int, lid: int) -> None:
        if lid == 0 or self._refs[partition][lid] < 1:
            raise ValueError(
                f"incref of unallocated page {lid} in partition {partition}")
        self._refs[partition][lid] += 1

    def decref(self, partition: int, lid: int) -> None:
        if lid == 0 or self._refs[partition][lid] < 1:
            raise ValueError(
                f"decref of unallocated page {lid} in partition {partition}")
        self._refs[partition][lid] -= 1
        if self._refs[partition][lid] == 0:
            self._free[partition].append(lid)

    def free_count(self, partition: int) -> int:
        return len(self._free[partition])

    def refcount(self, partition: int, lid: int) -> int:
        return self._refs[partition][lid]

    def check(self) -> None:
        """Assert every allocator invariant (fuzz-test hook)."""
        for part in range(self.n_partitions):
            refs, free = self._refs[part], self._free[part]
            assert refs[0] == 1, f"trash refcount {refs[0]} != 1 (p{part})"
            assert all(r >= 0 for r in refs), f"negative refcount (p{part})"
            assert len(set(free)) == len(free), f"free-list dup (p{part})"
            assert 0 not in free, f"trash page on free list (p{part})"
            for lid in free:
                assert refs[lid] == 0, \
                    f"free page {lid} has refcount {refs[lid]} (p{part})"
            on_free = set(free)
            for lid in range(1, self.pages_per_partition):
                if refs[lid] == 0:
                    assert lid in on_free, \
                        f"leaked page {lid} (ref 0, not free) (p{part})"


class _PrefixNode:
    """One cached prefix page. ``key`` is the page's token tuple;
    ``parent`` is the children-dict that CONTAINS this node (unlink is
    ``del parent[key]``); the node holds ONE allocator reference on
    ``(partition, lid)`` for as long as it exists."""

    __slots__ = ("key", "parent", "children", "partition", "lid", "stamp",
                 "depth")

    def __init__(self, key, parent, partition, lid, stamp, depth):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.partition = partition
        self.lid = lid
        self.stamp = stamp
        self.depth = depth


class RadixPrefixCache:
    """Radix tree over token prefixes at page granularity.

    One tree root per ``(data_rank, adapter_id)``, as in the reference: pages
    are resident on one rank's partitions, and adapters change the K/V
    content, so a page is never shared across adapters. The local engine of
    this port has one rank: its roots are ``(0, adapter_id)``.
    """

    def __init__(self, page: int):
        self.page = int(page)
        self._roots: Dict[Tuple[int, int],
                          Dict[Tuple[int, ...], _PrefixNode]] = {}
        self._clock = itertools.count()
        self.n_nodes = 0

    def _keys(self, tokens, n_pages: int):
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        return [tuple(toks[m * self.page:(m + 1) * self.page])
                for m in range(n_pages)]

    def match(self, rank: int, aid: int, tokens, max_pages: int,
              touch: bool = True) -> List[_PrefixNode]:
        """Longest cached page-chain for ``tokens`` (at most ``max_pages``
        pages deep). ``touch`` bumps the LRU stamp of every matched node."""
        chain: List[_PrefixNode] = []
        children = self._roots.get((rank, aid))
        if children is None or max_pages <= 0:
            return chain
        for key in self._keys(tokens, max_pages):
            node = children.get(key)
            if node is None:
                break
            if touch:
                node.stamp = next(self._clock)
            chain.append(node)
            children = node.children
        return chain

    def register(self, rank: int, aid: int, tokens,
                 pages: List[Tuple[int, int]],
                 allocator: BlockAllocator) -> int:
        """Walk/extend the tree along ``tokens``'s first ``len(pages)``
        full pages. Missing nodes are created holding ``pages[m]`` (the
        cache increfs — it owns its reference independently of any slot);
        existing nodes keep THEIR page untouched (the registering slot
        simply holds a duplicate copy). Returns the number of new nodes."""
        children = self._roots.setdefault((rank, aid), {})
        created = 0
        for m, key in enumerate(self._keys(tokens, len(pages))):
            node = children.get(key)
            if node is None:
                part, lid = pages[m]
                allocator.incref(part, lid)
                node = _PrefixNode(key, children, part, lid,
                                   next(self._clock), m)
                children[key] = node
                created += 1
                self.n_nodes += 1
            else:
                node.stamp = next(self._clock)
            children = node.children
        return created

    def nodes(self) -> Iterator[_PrefixNode]:
        stack = [n for root in self._roots.values() for n in root.values()]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def evict(self, allocator: BlockAllocator, partition: int, n: int,
              protect: FrozenSet[_PrefixNode] = frozenset()) -> int:
        """Free up to ``n`` pages in ``partition`` by dropping LRU LEAF
        nodes whose page is held by the cache alone (refcount 1) and that
        are not in ``protect``. Returns how many pages were freed. O(tree)
        per freed page — the tree is small relative to a decode step."""
        freed = 0
        while freed < n:
            victim = None
            for node in self.nodes():
                if (node.partition == partition and not node.children
                        and node not in protect
                        and allocator.refcount(node.partition, node.lid) == 1):
                    if victim is None or node.stamp < victim.stamp:
                        victim = node
            if victim is None:
                break
            allocator.decref(victim.partition, victim.lid)
            del victim.parent[victim.key]
            self.n_nodes -= 1
            freed += 1
        return freed


class PagedKVCache:
    """Drop-in replacement for :class:`SlotKVCache` backed by the paged pool:
    the same ``allocate/insert/advance/release/pos/cache`` surface
    the engine drives, plus page bookkeeping (``_ensure_span`` /
    ``ensure_decode``), per-slot adapters (``set_adapter``), prefix
    adoption and registration, eviction, admission accounting, and the
    engine-signature ``decode_fn`` / ``fused_fn`` / ``verify_fn``. The
    device table and adapter ids are resident across steps: host
    bookkeeping marks slot rows dirty, and the next launch patches just
    those rows. Every launch runs inside the model's adapter context
    (:func:`~elephas_tpu_torch.models.transformer._adapter_ctx`, a no-op
    for a plain model).

    ``pages_per_partition`` defaults to the dense-equivalent pool
    (``n_slots × pages_per_slot + trash``), where paged and dense emit the
    same tokens with zero preemptions; shrink it to trade device memory for
    occasional preemption under pressure. ``mesh`` must be ``None``.
    """

    def __init__(self, model, params, n_slots: int,
                 max_len: Optional[int] = None, page_size: int = 16,
                 pages_per_partition: Optional[int] = None,
                 prefix_cache: bool = True, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "paged serving over a mesh is not ported yet (ROADMAP.md "
                "queue 1, 'Speculation and sharding')")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if model._ring_cache:
            raise NotImplementedError(
                "PagedKVCache needs a linear (horizon) cache; all-windowed "
                "models allocate rolling buffers (see "
                "TransformerLM.prefill_slot)")
        self.model = model
        self.params = params
        self.n_slots = int(n_slots)
        self.max_len = int(model.max_len if max_len is None else max_len)
        if self.max_len > model.max_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's {model.max_len}")
        self.page = int(page_size)
        if self.page < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.capacity = aligned_cache_length(self.max_len)
        if self.capacity % self.page:
            raise ValueError(
                f"page_size {self.page} must divide the cache length "
                f"{self.capacity} (the dense-view bit-identity contract)")
        self.M = self.capacity // self.page     # logical pages per slot
        self.n_partitions = 1
        if pages_per_partition is None:
            pages_per_partition = self.n_slots * self.M + 1
        self.pages_per_partition = int(pages_per_partition)
        self.allocator = BlockAllocator(1, self.pages_per_partition)
        self.prefix: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.page) if prefix_cache else None)

        shape = (model.n_layers, self.pages_per_partition, model.n_kv_heads,
                 self.page, model.d_model // model.n_heads)
        self.cache = {n: torch.zeros(shape, dtype=model.compute_dtype,
                                     device=model.device) for n in ("k", "v")}

        S, M = self.n_slots, self.M
        self.table = np.zeros((S, M), np.int32)
        self.aids = np.zeros(S, np.int32)
        self.owned: List[Dict[int, Tuple[int, int]]] = [{} for _ in range(S)]
        self.pos = np.zeros(S, np.int32)
        self._free: List[int] = list(range(S - 1, -1, -1))
        self._table_dev: Optional[torch.Tensor] = None
        self._aids_dev: Optional[torch.Tensor] = None
        self._table_rows_dirty: set = set()
        self._aids_rows_dirty: set = set()
        self.preemptions = 0
        self._prefix_hits = 0
        self._prefix_lookups = 0

    # -- slot accounting (SlotKVCache surface) ---------------------------
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
        """Return the slot, drop its reference on every page it holds and
        reset its adapter to 0."""
        if slot in self._free or not 0 <= slot < self.n_slots:
            raise ValueError(f"bad release of slot {slot}")
        for part, lid in self.owned[slot].values():
            self.allocator.decref(part, lid)
        self.owned[slot] = {}
        self.table[slot, :] = 0
        self.aids[slot] = 0
        self.pos[slot] = 0
        self._table_rows_dirty.add(slot)
        self._aids_rows_dirty.add(slot)
        self._free.append(slot)

    def advance(self, slot: int) -> None:
        self.pos[slot] += 1

    def remaining(self, slot: int) -> int:
        """Positions ``slot`` can still write: ``max_len - pos[slot]`` (the
        host's write head, no device read)."""
        return self.max_len - int(self.pos[slot])

    # -- page bookkeeping ------------------------------------------------
    def set_adapter(self, slot: int, adapter_id: int) -> None:
        """Serve ``slot`` under adapter ``adapter_id`` from the next launch
        on (the engine sets it at admission, before prefix adoption)."""
        self.aids[slot] = int(adapter_id)
        self._aids_rows_dirty.add(slot)

    def _ensure_span(self, slot: int, lo: int, hi: int) -> None:
        """Allocate (idempotently) every page covering positions
        ``[lo, hi)`` of ``slot``. Raises :class:`PagesExhausted` mid-way
        on shortage — already-allocated pages stay owned, so the caller
        can evict/preempt and simply retry."""
        if hi <= lo:
            return
        for m in range(lo // self.page, (hi - 1) // self.page + 1):
            if m not in self.owned[slot]:
                lid = self.allocator.alloc(0)
                self.owned[slot][m] = (0, lid)
                self.table[slot, m] = lid
                self._table_rows_dirty.add(slot)

    def ensure_decode(self, slots, n_steps: int) -> None:
        """Allocate the pages the next ``n_steps`` decode writes of each
        active slot will land in (positions ``pos .. pos+n_steps-1``)."""
        for slot in slots:
            p = int(self.pos[slot])
            self._ensure_span(slot, p, p + n_steps)

    # -- prefix cache ----------------------------------------------------
    def adopt_prefix(self, slot: int, prompt) -> int:
        """Adopt the longest cached page-chain matching ``prompt`` for
        ``slot`` (pure increfs — cannot fail) and return how many PROMPT
        TOKENS are covered. Capped at ``(T0-1)//page`` pages so at least
        one real token remains to prefill (the first-token logits must
        come from a genuine forward)."""
        if self.prefix is None:
            return 0
        prompt = np.asarray(prompt).reshape(-1)
        cap = (len(prompt) - 1) // self.page
        self._prefix_lookups += cap
        chain = self.prefix.match(0, int(self.aids[slot]), prompt, cap)
        self._prefix_hits += len(chain)
        for m, node in enumerate(chain):
            self.allocator.incref(node.partition, node.lid)
            self.owned[slot][m] = (node.partition, node.lid)
            self.table[slot, m] = node.lid
            self._table_rows_dirty.add(slot)
        return len(chain) * self.page

    def register_prefix(self, slot: int, prompt) -> int:
        """Publish ``slot``'s full prompt pages into the radix tree. Called
        once prefill completes; partial tail pages and every page decode
        will write are excluded by construction."""
        if self.prefix is None:
            return 0
        prompt = np.asarray(prompt).reshape(-1)
        pages = [self.owned[slot][m] for m in range(len(prompt) // self.page)]
        return self.prefix.register(0, int(self.aids[slot]), prompt, pages,
                                    self.allocator)

    def evict_pages(self, partition: int, n: int,
                    protect: FrozenSet = frozenset()) -> int:
        """Drop up to ``n`` clean (cache-only) prefix pages from
        ``partition``; returns how many were actually freed."""
        if self.prefix is None:
            return 0
        return self.prefix.evict(self.allocator, partition, n, protect)

    # -- weight rollover --------------------------------------------------
    def flush_prefixes(self) -> int:
        """Drop EVERY cached prefix page (the cache's own references only)
        and return how many were released: cached pages hold K/V computed
        under the weights that prefilled them. Live slots keep their own
        references, so in-flight requests are untouched."""
        if self.prefix is None:
            return 0
        flushed = 0
        for node in list(self.prefix.nodes()):
            self.allocator.decref(node.partition, node.lid)
            flushed += 1
        self.prefix._roots.clear()
        self.prefix.n_nodes = 0
        return flushed

    def set_params(self, params) -> None:
        """Swap the weights future prefill inserts run under and flush the
        prefix cache (its pages were built under the old weights)."""
        self.params = params
        self.flush_prefixes()

    # -- admission -------------------------------------------------------
    def fits(self, total_len: int) -> bool:
        """Could a request of ``total_len`` total positions (prompt +
        budget) EVER hold its pages alone? Checked at submit so a too-big
        request is rejected instead of looping through preemption."""
        need = min(-(-int(total_len) // self.page), self.M)
        return need <= self.pages_per_partition - 1

    def admission_check(self, prompt, adapter_id: int,
                        rank: int) -> Tuple[int, int]:
        """``(free, need)`` page counts for admitting ``prompt`` under
        adapter ``adapter_id`` on data rank ``rank`` (0: one device): the
        pages a fresh insert plus the FIRST decode write would allocate
        beyond the prefix cached for that adapter. Where short, tries to
        evict clean prefix pages first (never the matched chain)."""
        if rank != 0:
            raise ValueError(f"rank {rank}: the local pool has data rank 0 only")
        prompt = np.asarray(prompt).reshape(-1)
        T0 = len(prompt)
        cap = (T0 - 1) // self.page
        chain = (self.prefix.match(0, int(adapter_id), prompt, cap, touch=False)
                 if self.prefix is not None else [])
        need = T0 // self.page + 1 - len(chain)
        free = self.allocator.free_count(0)
        if free < need:
            self.evict_pages(0, need - free, frozenset(chain))
            free = self.allocator.free_count(0)
        return free, need

    # -- device ops (SlotKVCache surface) --------------------------------
    def _resident(self, dev_copy, host, dirty: set):
        """A host array's resident device copy: uploaded whole once, after
        which the ``dirty`` rows are patched with one upload of their rows.
        Clears ``dirty``."""
        dev = self.model.device
        if dev_copy is None:
            dev_copy = torch.from_numpy(host.copy()).to(dev)
        elif dirty:
            rows = np.asarray(sorted(dirty), np.int64)
            idx, vals = torch.from_numpy(rows), torch.from_numpy(host[rows])
            if dev.type == "cuda":
                # pinned staging: the patch is queued on the stream with no
                # host sync
                idx = idx.pin_memory().to(dev, non_blocking=True)
                vals = vals.pin_memory().to(dev, non_blocking=True)
            dev_copy.index_copy_(0, idx, vals)
        dirty.clear()
        return dev_copy

    def _device_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The resident device block table ``[S, M]`` int32 and adapter ids
        ``[S]`` int32, each patched by its dirty rows (admission, release,
        page growth, adapter change). A steady decode step uploads
        nothing."""
        self._table_dev = self._resident(self._table_dev, self.table,
                                         self._table_rows_dirty)
        self._aids_dev = self._resident(self._aids_dev, self.aids,
                                        self._aids_rows_dirty)
        return self._table_dev, self._aids_dev

    def insert(self, slot: int, prompt: np.ndarray,
               pos0: int = 0) -> torch.Tensor:
        """Prefill ``prompt`` ``[T0]`` into ``slot`` at positions
        ``pos0..pos0+T0-1`` through the block table; returns the last REAL
        position's logits ``[V]``. Validation and bucketing match
        :meth:`SlotKVCache.insert`; ``pos0 > 0`` serves both
        chunked-prefill continuations and prefix-adopted suffixes (the chunk
        attends the adopted pages through the table). Raises
        :class:`PagesExhausted` when the pool cannot hold the span."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        T0 = prompt.shape[0]
        pos0 = int(pos0)
        if not 1 <= T0 <= self.max_len:
            raise ValueError(f"prompt length {T0} not in [1, {self.max_len}]")
        if not 0 <= pos0 <= self.max_len - T0:
            raise ValueError(
                f"pos0 {pos0} + chunk {T0} exceeds max_len {self.max_len}")
        Tb = min(bucket_length(T0), self.capacity - pos0)
        padded = np.zeros((1, Tb), np.int64)
        padded[0, :T0] = prompt
        self._ensure_span(slot, pos0, pos0 + T0)
        table, aids = self._device_tables()
        tokens = torch.from_numpy(padded).to(self.model.device)
        with _adapter_ctx(self.model, aids[slot:slot + 1]):
            logits, _ = self.model.decode_chunk_paged(
                self.params, tokens, pos0, self.cache, table[slot:slot + 1],
                self.page)
        self.pos[slot] = pos0 + T0
        return logits[0, T0 - 1]

    def _step(self, table, aids):
        def step(params, tokens, pos, cache):
            with _adapter_ctx(self.model, aids):
                return self.model.decode_step_paged(params, tokens, pos, cache,
                                                    table, self.page)
        return step

    def decode_fn(self, params, cache, tokens, pos, temps, seeds, live,
                  sampled: bool):
        """Engine-signature single decode step over every slot: each layer
        writes one new K/V row per slot into its page and attends through
        the table → ``(emitted [S], tokens, pos)``. Slots whose cell at the
        write position is unmapped (free rows, chunk-parked rows at a page
        boundary) write into the trash page."""
        emit, tokens, pos = self.fused_fn(params, cache, tokens, pos, temps,
                                          seeds, live, 1, sampled)
        return emit[:, 0], tokens, pos

    def fused_fn(self, params, cache, tokens, pos, temps, seeds, live,
                 n_steps: int, sampled: bool):
        """Engine-signature fused multi-step decode: ``n_steps`` paged steps
        back to back, ``(emitted [S, n_steps], tokens, pos)``, the same
        tokens as ``n_steps`` single steps."""
        return decode_block(self._step(*self._device_tables()), params, cache,
                            tokens, pos, temps, seeds, live, n_steps, sampled)

    def verify_fn(self, params, cache, drafts, tokens, pos, temps, seeds,
                  live, sampled: bool):
        """Engine-signature speculative verify straight over the pool (the
        reference's ``_paged_verify_kernel``): score the carry and ``W``
        drafts per slot as ONE ``decode_chunk_paged`` through the device
        table (the paged chunk kernel on the card), then accept as the dense
        engine does → ``(sel [S, W+1], n_accepted [S], tokens, pos)``. The
        whole chunk's K/V, rejected tail included, lands in the slot's own
        pages, which the engine allocates for ``pos..pos+W`` before the
        launch. That is safe: pages a decode writes are never published to
        the prefix cache, and the next round rewrites every position past
        the accepted run before anything attends it. Free rows write into
        the trash page."""
        chunk = torch.cat([tokens[:, None], drafts], dim=1)
        table, aids = self._device_tables()
        with _adapter_ctx(self.model, aids):
            logits, _ = self.model.decode_chunk_paged(
                params, chunk, pos, cache, table, self.page)
        return spec_commit(logits, drafts, tokens, pos, temps, seeds, live,
                           sampled)

    # -- observability / integrity ---------------------------------------
    def memory_stats(self) -> Dict[str, Any]:
        """JSON-able snapshot section: page utilization, device bytes of the
        pool, prefix-hit ratio, preemption count."""
        total = self.pages_per_partition - 1
        free = self.allocator.free_count(0)
        used = total - free
        k = self.cache["k"]
        bytes_ = 2 * k.numel() * k.element_size()
        L, _, Hkv, _, Dh = k.shape
        # one K+V time-row: the only per-token copy the paged kernels pay
        row_bytes = 2 * L * Hkv * Dh * k.element_size()
        return {
            "page_size": self.page,
            "pages_per_partition": self.pages_per_partition,
            "n_partitions": self.n_partitions,
            "pages_total": total,
            "pages_used": used,
            "pages_free": free,
            "page_utilization": used / total if total else 0.0,
            "kv_hbm_bytes": bytes_,
            "copy_bytes_per_token": row_bytes,
            "copy_bytes_per_step_gathered": row_bytes * (self.capacity + 1),
            "preemptions": self.preemptions,
            "prefix": {
                "nodes": self.prefix.n_nodes if self.prefix else 0,
                "hits_pages": self._prefix_hits,
                "lookups_pages": self._prefix_lookups,
                "hit_ratio": (self._prefix_hits / self._prefix_lookups
                              if self._prefix_lookups else 0.0),
            },
        }

    def check(self) -> None:
        """Assert full cross-structure integrity: allocator invariants,
        refcount == (#owning slots + cache hold) for every page, and
        table/ownership agreement. Fuzz-test hook."""
        self.allocator.check()
        expect: Dict[Tuple[int, int], int] = {}
        for d in self.owned:
            for key in d.values():
                expect[key] = expect.get(key, 0) + 1
        if self.prefix is not None:
            for node in self.prefix.nodes():
                key = (node.partition, node.lid)
                expect[key] = expect.get(key, 0) + 1
        for lid in range(1, self.pages_per_partition):
            want = expect.get((0, lid), 0)
            got = self.allocator.refcount(0, lid)
            assert got == want, \
                f"page {lid}: refcount {got} != {want} holders"
        for s in range(self.n_slots):
            for m in range(self.M):
                lid = int(self.table[s, m])
                if m in self.owned[s]:
                    assert lid == self.owned[s][m][1], \
                        f"table[{s},{m}]={lid} disagrees with ownership"
                else:
                    assert lid == 0, \
                        f"table[{s},{m}]={lid} but page not owned"
