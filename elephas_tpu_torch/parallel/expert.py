"""Mixture-of-experts FFN on one device (port of the single-device part of
``elephas_tpu/parallel/expert.py``).

A learned router sends each token to its top-``k`` experts (GShard
routing: iterated argmax, the first index winning ties; ``k``-th choices
queue behind all earlier choices; a choice is kept iff its queue position
is below the capacity; combine weights renormalised over the kept
choices). :class:`MoEFeedForward` runs the experts by one of four
executors that make the same routing decisions:

- :meth:`~MoEFeedForward.apply_gmm`: rows sorted by expert into a
  tile-aligned buffer and each projection one grouped matmul
  (``ops/grouped_matmul.py``: the K6 kernels on the card, the plain
  versions on the CPU); for swiglu experts without biases the FFN is one
  recompute-backward ``autograd.Function`` (:func:`_moe_ffn_swiglu`).
- :meth:`~MoEFeedForward.apply_slots`: index-form dispatch into capacity
  slots and one batched product per projection.
- :meth:`~MoEFeedForward.apply_grouped`: a stable sort by expert and one
  ``torch.matmul`` per expert over its contiguous rows (the reference's
  ``jax.lax.ragged_dot``, which is XLA work and not a kernel).
- :meth:`~MoEFeedForward.apply_reference`: the GShard one-hot oracle
  (also the only executor of expert-choice routing).

The buffer build and read-back of the slot and grouped-matmul executors
are gathers whose backwards are gathers too (:func:`_rows_to_slots`,
:func:`_slots_to_rows`): the default backward of a gather is a scatter-add,
which on the card uses atomics and gives other bits each run. The tile
layout (:meth:`~MoEFeedForward._tile_layout`) is built with device ops of
static shape, so a decode step needs no host sync per layer.

Expert parallelism (the ``all_to_all`` dispatch of :meth:`apply`, the
replicated-routing :meth:`apply_partial`, sharding specs, the mesh and the
dp×ep train step) is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from ..models.transformer import glorot
from ..ops import grouped_matmul as G

EXPERT_AXIS = "expert"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SHARDED = ("expert parallelism (all_to_all dispatch, sharded expert stacks, "
            "the dp x ep train step) is not ported yet (ROADMAP.md queue 1, "
            "items 6 and 11)")


def build_mesh_ep(*args, **kwargs):
    """The reference's ``("data", "expert")`` mesh; not ported yet."""
    raise NotImplementedError(_SHARDED)


def build_ep_train_step(*args, **kwargs):
    """The reference's dp×ep train step; not ported yet."""
    raise NotImplementedError(_SHARDED)


def _one_hot(idx, n: int, dtype):
    """``[..., n]`` one-hot of ``idx`` in ``dtype`` (no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_dispatch(gates, capacity: int, k: int):
    """GShard top-k dispatch from router probabilities ``gates`` ``[N, E]``
    → ``(dispatch [N, E, C] one-hot, combine [N, E, C] weights, (first-choice
    counts [E], summed router probs [E], N))``. Slots are claimed in token
    order, ``k``-th choices behind all earlier ones; combine weights
    renormalise over the token's kept choices."""
    n, e = gates.shape
    dt = gates.dtype
    masks, g = [], gates
    for _ in range(k):
        m = _one_hot(torch.argmax(g, dim=-1), e, dt)
        masks.append(m)
        g = g * (1.0 - m)          # exclude the chosen expert next round
    pos, counts = [], torch.zeros(e, dtype=dt, device=gates.device)
    for m in masks:
        pos.append(torch.cumsum(m, dim=0) - m + counts[None, :])
        counts = counts + m.sum(dim=0)
    dispatch = torch.zeros((n, e, capacity), dtype=dt, device=gates.device)
    combine_w = torch.zeros((n, e), dtype=dt, device=gates.device)
    for m, p_ in zip(masks, pos):
        keep = m * (p_ < capacity).to(dt)
        slot = (p_ * keep).sum(dim=-1).to(torch.int64)
        dispatch = dispatch + keep[:, :, None] * _one_hot(slot, capacity, dt)[:, None, :]
        combine_w = combine_w + keep * gates
    denom = combine_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    combine = (combine_w / denom)[:, :, None] * dispatch
    aux = (masks[0].sum(dim=0), gates.sum(dim=0),
           torch.tensor(float(n), dtype=dt, device=gates.device))
    return dispatch, combine, aux


def _top_k_select(gates, capacity: int, k: int):
    """:func:`_top_k_dispatch`'s routing in index form: ``(eidx [N, k],
    slot [N, k], combine [N, k], (c1 [E], gsum [E]))``, ``eidx``/``slot``
    int64. ``slot`` is the choice's queue position at its expert (``>=
    capacity`` means dropped), ``combine`` is zero for dropped choices,
    ``c1``/``gsum`` the first-choice counts and summed router probs. The
    queue positions are an integer cumsum (the reference's float cumsum of
    one-hots is exact, so the decisions agree bit for bit)."""
    n, e = gates.shape
    g = gates
    counts = torch.zeros(e, dtype=torch.int64, device=gates.device)
    eidxs, slots, keeps, first = [], [], [], None
    for _ in range(k):
        idx = torch.argmax(g, dim=-1)
        m = _one_hot(idx, e, torch.int64)
        if first is None:
            first = m
        pos = torch.cumsum(m, dim=0) - m + counts[None, :]
        slot = pos.gather(1, idx[:, None])[:, 0]
        keeps.append(slot < capacity)
        slots.append(slot)
        eidxs.append(idx)
        counts = counts + m.sum(dim=0)
        g = g * (1.0 - m.to(gates.dtype))
    eidx = torch.stack(eidxs, dim=1)
    slot = torch.stack(slots, dim=1)
    keep = torch.stack(keeps, dim=1)
    gv = gates.gather(1, eidx) * keep.to(gates.dtype)
    denom = gv.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return eidx, slot, gv / denom, (first.sum(dim=0).to(gates.dtype),
                                    gates.sum(dim=0))


def _gather_rows(src, idx):
    """``src[idx]`` with every index outside ``[0, len(src))`` (the
    sentinels) reading a zero row."""
    n = src.shape[0]
    valid = (idx >= 0) & (idx < n)
    rows = src[idx.clamp(0, max(n - 1, 0))]
    return rows.masked_fill(~valid[:, None], 0)


class _RowsToSlots(torch.autograd.Function):
    """``blocks[s] = x[tos[s]]`` (sentinel rows → 0) with a GATHER backward:
    the slot assignment is injective, token ``n``'s kept copies living at
    ``flat[n, j]``, so ``dx[n]`` is the sum of those ``k`` rows masked by
    ``keep``."""

    @staticmethod
    def forward(ctx, x, tos, flat, keep):
        ctx.save_for_backward(flat, keep)
        return _gather_rows(x, tos)

    @staticmethod
    def backward(ctx, g):
        flat, keep = ctx.saved_tensors
        n, k = flat.shape
        dx = g[flat.reshape(-1)].reshape(n, k, -1)
        return (dx * keep[..., None].to(g.dtype)).sum(dim=1), None, None, None


class _SlotsToRows(torch.autograd.Function):
    """``rows[i] = out_flat[flat[i]]`` for flattened (token, choice) pairs,
    with a GATHER backward through the inverse map ``cell`` (slot →
    claiming pair, sentinel ``N·k`` → zero). Dropped pairs read a clipped
    slot forward but carry a zero combine weight, so an inverse covering
    only the kept pairs is exact."""

    @staticmethod
    def forward(ctx, out_flat, flat, cell):
        ctx.save_for_backward(cell)
        return out_flat[flat]

    @staticmethod
    def backward(ctx, g):
        (cell,) = ctx.saved_tensors
        return _gather_rows(g, cell), None, None


def _rows_to_slots(x, tos, flat, keep):
    return _RowsToSlots.apply(x, tos, flat, keep)


def _slots_to_rows(out_flat, flat, cell):
    return _SlotsToRows.apply(out_flat, flat, cell)


class _MoeFfnSwiglu(torch.autograd.Function):
    """``(silu(xs·w1[g]) ⊙ xs·w3[g]) · w2[g]`` over the tile-aligned buffer
    with a RECOMPUTE backward: only ``xs``, the weights and ``gmap`` are
    saved, and the three ``[M, F]`` intermediates are rebuilt by two grouped
    matmuls in the backward (5 ``gmm``, 3 ``gmm_t`` and 3 ``tgmm`` per
    forward and backward)."""

    @staticmethod
    def forward(ctx, xs, w1, w2, w3, gmap):
        ctx.save_for_backward(xs, w1, w2, w3, gmap)
        h = F.silu(G.gmm(xs, w1, gmap)) * G.gmm(xs, w3, gmap)
        return G.gmm(h, w2, gmap)

    @staticmethod
    def backward(ctx, dout):
        xs, w1, w2, w3, gmap = ctx.saved_tensors
        E = w1.shape[0]
        u = G.gmm(xs, w1, gmap)
        v = G.gmm(xs, w3, gmap)
        sig = torch.sigmoid(u)
        su = u * sig
        h = su * v
        dh = G.gmm_t(dout, w2, gmap)
        dv = dh * su
        du = dh * v * (sig + su * (1.0 - sig))  # d silu(u) = σ(u)(1 + u(1-σ))
        dxs = G.gmm_t(du, w1, gmap) + G.gmm_t(dv, w3, gmap)
        dw1 = G.tgmm(xs, du, gmap, E, w1.dtype)
        dw3 = G.tgmm(xs, dv, gmap, E, w3.dtype)
        dw2 = G.tgmm(h, dout, gmap, E, w2.dtype)
        return dxs, dw1, dw2, dw3, None


def _moe_ffn_swiglu(xs, w1, w2, w3, gmap):
    return _MoeFfnSwiglu.apply(xs, w1, w2, w3, gmap)


def _expert_choice_dispatch(gates, capacity: int):
    """Expert-choice routing: each expert picks its top-``capacity`` tokens
    by gate score, ties to the lowest token index (a stable descending
    sort); the combine weight is the score. Returns ``(dispatch [E, C, N]
    one-hot, combine [E, C, N])``."""
    vals, idx = torch.sort(gates.T, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :capacity], idx[:, :capacity]
    dispatch = _one_hot(idx, gates.shape[0], gates.dtype)
    return dispatch, dispatch * vals[..., None]


class MoEFeedForward:
    """Top-k routed expert FFN (``D → F → D`` per expert; relu by default,
    or swiglu/gelu via ``activation``, with optional biases; the Mixtral
    expert is ``activation="swiglu", bias=False``).

    ``capacity_factor`` sizes each expert's buffer per dispatch group as
    ``ceil(cf · k · N_group / E)``. ``param_dtype`` is the storage dtype of
    the expert stacks only; the router ``wg`` stays float32 (routing
    argmaxes must be stable against the oracle)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, k: int = 2,
                 capacity_factor: float = 1.25,
                 routing: str = "token_choice", activation: str = "relu",
                 bias: bool = True, param_dtype="float32"):
        if n_experts < k:
            raise ValueError(f"need n_experts >= k, got {n_experts} < {k}")
        if routing not in ("token_choice", "expert_choice"):
            raise ValueError(f"Unknown routing: {routing}")
        if activation not in ("relu", "gelu", "swiglu"):
            raise ValueError(f"Unknown activation: {activation}")
        if param_dtype not in _DTYPES:
            raise ValueError(f"Unknown param_dtype: {param_dtype}")
        self.d_model = d_model
        self.d_ff = d_ff
        self.n_experts = n_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.routing = routing
        self.activation = activation
        self.bias = bool(bias)
        self.param_dtype = _DTYPES[param_dtype]

    # -- parameters ---------------------------------------------------------
    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Name → shape in the reference's order, which fixes the order of
        :meth:`init`'s draws; every stack but ``wg`` is in ``param_dtype``."""
        E, D, F_ = self.n_experts, self.d_model, self.d_ff
        shapes = {"wg": (D, E), "w1": (E, D, F_), "b1": (E, F_),
                  "w2": (E, F_, D), "b2": (E, D)}
        if self.activation == "swiglu":
            shapes["w3"] = (E, D, F_)
        if not self.bias:
            del shapes["b1"], shapes["b2"]
        return shapes

    def init(self, seed: int = 0, device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
        """The reference's numpy draws from ``seed`` (glorot for weights,
        zeros for biases) as tensors on ``device``."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        out = {}
        for name, shape in self.param_shapes().items():
            a = (glorot(rng, *shape) if name.startswith("w")
                 else np.zeros(shape, np.float32))
            dt = torch.float32 if name == "wg" else self.param_dtype
            out[name] = torch.from_numpy(a).to(device=dev, dtype=dt)
        return out

    def expert_keys(self):
        """The per-expert stacked param names (all but the router)."""
        return tuple(k for k in self.param_shapes() if k != "wg")

    def specs(self):
        raise NotImplementedError(_SHARDED)

    def shard_params(self, mesh, params):
        raise NotImplementedError(_SHARDED)

    def capacity(self, n_shard: int) -> int:
        """Per-(expert, dispatch-group) slot count for ``n_shard`` tokens:
        ``ceil(cf · k · n / E)``, at least 1."""
        return max(1, int(math.ceil(self.capacity_factor * self.k * n_shard
                                    / self.n_experts)))

    # -- the experts --------------------------------------------------------
    def _expert_ffn(self, *args):
        """Every expert's FFN at once: weights ``[E, ...]`` and biases ``[E,
        .]`` in :meth:`_expert_args` order, then ``x`` — ``[E, C, D]`` (one
        block per expert) or ``[N, D]`` (every token through every expert)
        → ``[E, C or N, D]``."""
        if self.activation == "swiglu":
            if self.bias:
                w1, w2, w3, b1, b2, x = args
                h = F.silu(x @ w1 + b1[:, None]) * (x @ w3)
                return h @ w2 + b2[:, None]
            w1, w2, w3, x = args
            return (F.silu(x @ w1) * (x @ w3)) @ w2
        act = F.relu if self.activation == "relu" else (
            lambda u: F.gelu(u, approximate="tanh"))
        if self.bias:
            w1, w2, b1, b2, x = args
            return act(x @ w1 + b1[:, None]) @ w2 + b2[:, None]
        w1, w2, x = args
        return act(x @ w1) @ w2

    def _expert_args(self, params):
        """Expert stacks in :meth:`_expert_ffn`'s order (weights, then
        biases)."""
        ws = [params[k] for k in self.expert_keys() if k.startswith("w")]
        bs = [params[k] for k in self.expert_keys() if k.startswith("b")]
        return ws + bs

    @staticmethod
    def _gates(x, params):
        """Router probabilities ``softmax(x · wg)`` in float32."""
        return torch.softmax(x.to(torch.float32) @ params["wg"].to(torch.float32),
                             dim=-1)

    def _groups(self, x, ep: int, what: str):
        if self.routing != "token_choice" and what != "apply_reference":
            raise ValueError(f"{what} implements token_choice routing only; "
                             "use apply_reference for expert_choice")
        n = x.shape[0]
        if n % ep:
            raise ValueError(f"{n} tokens not divisible by ep={ep}")
        return self.capacity(n // ep), torch.split(x, n // ep) if n else [x]

    def _aux(self, c1s, gsums, n: int):
        """The Switch load-balancing loss ``E · Σ_e f_e · p_e`` from the
        groups' first-choice counts and summed router probs."""
        c1, gsum = sum(c1s), sum(gsums)
        return self.n_experts * torch.sum((c1 / n) * (gsum / n))

    # -- sharded executors (not ported) -------------------------------------
    def apply(self, params, x, axis_name: str = EXPERT_AXIS):
        """The all_to_all expert-parallel forward; not ported yet."""
        raise NotImplementedError(_SHARDED)

    def apply_partial(self, params, x, n_local: int, e0):
        """The replicated-routing expert-partial forward; not ported yet."""
        raise NotImplementedError(_SHARDED)

    # -- index-form capacity slots ------------------------------------------
    def _slot_dispatch(self, x, gates, cap: int):
        """Token-choice index-form dispatch: ``x [N, D]`` and router
        ``gates`` → ``(blocks [E, C, D], cell, flat, combine, c1, gsum)``.
        ``cell[s]`` is the flattened (token, choice) pair claiming slot
        ``s`` (sentinel ``N·k``); over-capacity pairs land in a spare column
        that is cut off. The blocks stay in ``x``'s dtype."""
        n_l, E, k = x.shape[0], self.n_experts, self.k
        eidx, slot, combine, (c1, gsum) = _top_k_select(gates, cap, k)
        sent = n_l * k
        pair = torch.arange(sent, device=x.device)
        cell = torch.full((E, cap + 1), sent, dtype=torch.int64, device=x.device)
        cell[eidx.reshape(-1), slot.clamp(max=cap).reshape(-1)] = pair
        cell = cell[:, :cap].reshape(-1)
        tok_of_cell = torch.where(cell == sent, n_l, cell // k)
        keep = slot < cap
        flat = eidx * cap + slot.clamp(max=cap - 1)      # [N, k] slot ids
        blocks = _rows_to_slots(x, tok_of_cell, flat, keep).reshape(
            E, cap, self.d_model)
        return blocks, cell, flat, combine, c1, gsum

    def _slot_combine(self, out, cell, flat, combine, n_l: int):
        """Weighted gather of each token's ``k`` expert outputs (float32)."""
        f32 = torch.float32
        rows = _slots_to_rows(out.reshape(-1, self.d_model), flat.reshape(-1),
                              cell).reshape(n_l, self.k, self.d_model).to(f32)
        return (rows * combine[..., None].to(f32)).sum(dim=1)

    def apply_slots(self, params, x, ep: int = 1):
        """:meth:`apply_reference`'s contract by the index-form (gather)
        dispatch into capacity slots, one batched product per projection:
        ``(y [N, D] float32, aux)``. ``token_choice`` only."""
        cap, blocks_in = self._groups(x, ep, "apply_slots")
        ys, c1s, gsums = [], [], []
        for blk in blocks_in:
            blocks, cell, flat, combine, c1, gsum = self._slot_dispatch(
                blk, self._gates(blk, params), cap)
            args = [a.to(blocks.dtype) for a in self._expert_args(params)]
            out = self._expert_ffn(*args, blocks)
            ys.append(self._slot_combine(out, cell, flat, combine, blk.shape[0]))
            c1s.append(c1)
            gsums.append(gsum)
        return torch.cat(ys, dim=0), self._aux(c1s, gsums, x.shape[0])

    # -- sort + per-expert matmul -------------------------------------------
    def _grouped_block(self, params, x, capacity: int):
        """One dispatch group by a stable sort of the (token, choice) pairs
        by expert and one ``torch.matmul`` per expert over its contiguous
        rows: exactly ``k·N`` rows, no capacity padding. Over-capacity pairs
        keep their rows but carry a zero combine weight."""
        n, k = x.shape[0], self.k
        eidx, _, combine, (c1, gsum) = _top_k_select(self._gates(x, params),
                                                     capacity, k)
        cd = x.dtype
        eflat = eidx.reshape(n * k)
        order = torch.argsort(eflat, stable=True)   # sorted-by-expert rows
        inv = torch.argsort(order, stable=True)     # sorted row -> flat pair
        xs = x[order // k]
        ends = torch.cumsum(_one_hot(eflat, self.n_experts, torch.int64).sum(0),
                            0).tolist()
        bounds = list(zip([0] + ends[:-1], ends))
        if self.bias:
            es = eflat[order]                         # sorted expert per row

        def rdot(key, rows):
            w = params[key].to(cd)
            return torch.cat([rows[a:b] @ w[e] for e, (a, b) in enumerate(bounds)])

        u = rdot("w1", xs)
        if self.bias:
            u = u + params["b1"].to(cd)[es]
        if self.activation == "swiglu":
            u = F.silu(u) * rdot("w3", xs)
        elif self.activation == "gelu":
            u = F.gelu(u, approximate="tanh")
        else:
            u = F.relu(u)
        out = rdot("w2", u)
        if self.bias:
            out = out + params["b2"].to(cd)[es]
        out = out[inv].reshape(n, k, self.d_model)
        return (out * combine[..., None].to(cd)).sum(dim=1), c1, gsum

    def apply_grouped(self, params, x, ep: int = 1):
        """:meth:`apply_reference`'s contract (same routing, per-``ep``-group
        capacity quotas and aux loss) by sort + per-expert matmul: ``(y [N,
        D] in x's dtype, aux)``. ``token_choice`` only."""
        cap, blocks_in = self._groups(x, ep, "apply_grouped")
        ys, c1s, gsums = [], [], []
        for blk in blocks_in:
            y, c1, gsum = self._grouped_block(params, blk, cap)
            ys.append(y)
            c1s.append(c1)
            gsums.append(gsum)
        return torch.cat(ys, dim=0), self._aux(c1s, gsums, x.shape[0])

    # -- tile-aligned grouped matmul ----------------------------------------
    def _tile_layout(self, eidx, slot, n: int, tm: int):
        """Tile-aligned sorted-by-expert row layout for the grouped matmul:
        expert ``e``'s pairs occupy rows ``off[e] + slot``, ``off`` the
        exclusive cumsum of the per-expert claim counts rounded up to a
        multiple of ``tm`` and at least one tile (so :func:`tgmm` visits
        every expert). The buffer height ``M_pad = ceil((k·N + E·tm)/tm)·tm``
        is fixed by the shapes. Built with device ops only (no host sync).

        Returns ``(row [N, k], inv [M_pad], tok_of_row [M_pad], gmap
        [M_pad/tm] int32)``: pair → buffer row (injective), its inverse
        (sentinel ``N·k`` for padding rows), the gather index building the
        buffer (sentinel ``N`` → a zero row), and the non-decreasing tile →
        expert map."""
        E, k = self.n_experts, self.k
        dev = eidx.device
        sizes = _one_hot(eidx.reshape(-1), E, torch.int64).sum(dim=0)
        padded = torch.clamp((sizes + tm - 1) // tm, min=1) * tm
        cum = torch.cumsum(padded, dim=0)
        off = cum - padded
        row = off[eidx] + slot                       # [N, k]
        m_pad = -(-(n * k + E * tm) // tm) * tm
        sent = n * k
        inv = torch.full((m_pad,), sent, dtype=torch.int64, device=dev)
        inv[row.reshape(-1)] = torch.arange(sent, device=dev)
        tok_of_row = torch.where(inv == sent, n, inv // k)
        tile_start = torch.arange(m_pad // tm, device=dev) * tm
        gmap = torch.searchsorted(cum, tile_start, right=True).clamp(0, E - 1)
        return row, inv, tok_of_row, gmap.to(torch.int32)

    def _gmm_ffn_fused(self, params, xs, gmap):
        """The swiglu, bias-free expert FFN as one recompute-backward op."""
        cd = xs.dtype
        return _moe_ffn_swiglu(xs, params["w1"].to(cd), params["w2"].to(cd),
                               params["w3"].to(cd), gmap)

    def _gmm_ffn(self, params, xs, gmap, tm: int):
        """The grouped projections over the tile-aligned buffer through the
        differentiable :func:`gmm` (any activation, optional biases)."""
        cd = xs.dtype

        def mm(rows, key):
            return G.gmm(rows, params[key].to(cd), gmap)

        u = mm(xs, "w1")
        if self.bias:
            e_of_row = gmap.to(torch.int64).repeat_interleave(tm)
            u = u + params["b1"].to(cd)[e_of_row]
        if self.activation == "swiglu":
            h = F.silu(u) * mm(xs, "w3")
        elif self.activation == "gelu":
            h = F.gelu(u, approximate="tanh")
        else:
            h = F.relu(u)
        out = mm(h, "w2")
        if self.bias:
            out = out + params["b2"].to(cd)[e_of_row]
        return out

    def _gmm_block(self, params, x, capacity: int, tm: int):
        """One dispatch group through the grouped-matmul executor: the
        shared routing, the tile layout, the buffer built and read back by
        the gather-only Functions. Dropped pairs own a buffer row but carry
        a zero combine weight."""
        n = x.shape[0]
        eidx, slot, combine, (c1, gsum) = _top_k_select(
            self._gates(x, params), capacity, self.k)
        row, inv, tok_of_row, gmap = self._tile_layout(eidx, slot, n, tm)
        keep_all = torch.ones(eidx.shape, dtype=torch.bool, device=x.device)
        xs = _rows_to_slots(x, tok_of_row, row, keep_all)
        if self.activation == "swiglu" and not self.bias:
            out = self._gmm_ffn_fused(params, xs, gmap)
        else:
            out = self._gmm_ffn(params, xs, gmap, tm)
        f32 = torch.float32
        rows = _slots_to_rows(out, row.reshape(-1), inv).reshape(
            n, self.k, self.d_model).to(f32)
        return (rows * combine[..., None].to(f32)).sum(dim=1), c1, gsum

    def apply_gmm(self, params, x, ep: int = 1, tm: int = 128, interpret=None):
        """:meth:`apply_reference`'s contract (same routing, per-``ep``-group
        capacity quotas and aux loss) with each projection one grouped
        matmul over a tile-aligned buffer of ``k·N`` rows plus at most
        ``E·tm`` rows of padding: ``(y [N, D] float32, aux)``. The K6
        kernels on CUDA tensors (``tm`` a multiple of 128), the plain
        versions on CPU tensors. ``token_choice`` only. ``interpret`` is
        the reference's Pallas knob, accepted in its place and ignored."""
        cap, blocks_in = self._groups(x, ep, "apply_gmm")
        ys, c1s, gsums = [], [], []
        for blk in blocks_in:
            y, c1, gsum = self._gmm_block(params, blk, cap, tm)
            ys.append(y)
            c1s.append(c1)
            gsums.append(gsum)
        return torch.cat(ys, dim=0), self._aux(c1s, gsums, x.shape[0])

    # -- the oracle ---------------------------------------------------------
    def apply_reference(self, params, x, ep: int = 1):
        """Single-device oracle: the same routing, every token through every
        expert, weighed by the combine weights (no slot bookkeeping). ``ep``
        emulates ``ep`` contiguous dispatch groups, each with its own
        capacity. Expert-choice routing is the one-hot top-``C`` per expert
        and has no aux loss. Returns ``(y [N, D] float32, aux)``."""
        cap, blocks_in = self._groups(x, ep, "apply_reference")
        ys, c1s, gsums = [], [], []
        for blk in blocks_in:
            gates = self._gates(blk, params)
            if self.routing == "expert_choice":
                _, ec_combine = _expert_choice_dispatch(
                    gates, min(cap, blk.shape[0]))
                w = ec_combine.sum(dim=1).T               # [Nb, E]
            else:
                _, combine, (c1, gsum, _) = _top_k_dispatch(gates, cap, self.k)
                w = combine.sum(dim=-1)                   # [Nb, E]
                c1s.append(c1)
                gsums.append(gsum)
            args = self._expert_args(params)
            cd = torch.promote_types(blk.dtype, args[0].dtype)
            out_all = self._expert_ffn(*[a.to(cd) for a in args], blk.to(cd))
            ys.append(torch.einsum("ne,end->nd", w, out_all.to(w.dtype)))
        y = torch.cat(ys, dim=0)
        if self.routing == "expert_choice":
            return y, torch.zeros((), dtype=torch.float32, device=x.device)
        return y, self._aux(c1s, gsums, x.shape[0])
