"""Decoder-only transformer LM (port of ``elephas_tpu/models/transformer.py``):
serving, teacher-forced training and batched generation.

The model keeps the reference's functional shape: parameters are a flat
dict of named tensors with the same names and stacked ``[L, ...]`` layouts
(so a checkpoint moves between the packages with no mapping, see
``convert.py``), and every method takes ``params`` explicitly, which is what
lets the serving engine hot-swap weights and the train step stay a pure
function of ``(params, opt_state, batch)``.

- Serving: :meth:`~TransformerLM.decode_step` (one token per row,
  attention in the flash-decode kernel), :meth:`~TransformerLM.decode_chunk`
  (a block of tokens, plain attention against the cache) and
  :meth:`~TransformerLM.prefill_slot`.
- Training: :meth:`~TransformerLM.apply` / ``apply_with_aux`` /
  ``apply_hidden`` (the teacher-forced forward, attention ``"dense"`` in
  plain PyTorch or ``"flash"`` through the flash-attention kernels, forward
  and backward; a rotary model on ``"flash"`` rotates q and k inside the
  rope-on-load kernels), the losses (:func:`chunked_summed_xent` streams
  the head), per-layer rematerialisation, and :func:`build_lm_train_step` /
  :func:`build_lm_eval_step` on one device.
- Generation: :meth:`~TransformerLM.prefill` (the full forward over the
  prompt, flash attention), :meth:`~TransformerLM.generate` (one prefill,
  then a loop of cached decode steps; greedy, temperature, top-k, top-p)
  and :meth:`~TransformerLM.generate_speculative` (a draft model proposes,
  one chunk verifies; :func:`spec_round_accept` and, for the serving
  engine, :func:`spec_verify_select` are its accept rules).

Every LayerNorm goes through the fused kernels on the card, backward
included. Architecture knobs ported: relu / gelu (tanh) / swiglu, layernorm
/ rmsnorm, attention and FFN biases, learned / rotary positions, tied
embeddings, grouped-query attention, float32 or bfloat16 compute, and the
mixture-of-experts variant :class:`MoETransformerLM` (routed expert FFNs
on the grouped-matmul kernels, its load-balancing loss in the training
objective), and sliding-window attention (the Mistral convention, one
window for every layer or one per layer): the kernels mask by the window,
and a model whose every layer is windowed decodes over a rolling cache of
O(window) slots, position ``p`` in slot ``p mod T``
(:func:`write_prompt_cache`, :meth:`~TransformerLM.init_cache`). LoRA lives
in ``lora.py``: a :class:`~elephas_tpu_torch.models.lora.LoRATensor` weight
passes through every place this module reads a weight, and
:class:`~elephas_tpu_torch.models.lora.MultiTenantLM` (re-exported here)
adds per-row adapter deltas in :meth:`~TransformerLM._attn_proj`, entered
through :func:`_adapter_ctx`. Sequence and expert parallelism (``mesh``,
``attn="ring"``/``"ulysses"``) and ``overlap_grads`` are later slices and
raise ``NotImplementedError``.

JAX's arrays are immutable and its serving kernels donate the KV cache so
XLA updates it in place; here the cache is updated in place explicitly
(slice assignment or ``scatter_``), and the methods return the same dict
they were given. The train step returns new parameter and optimizer-state
dicts and leaves its arguments untouched.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import DeviceLike, resolve_device
from ..ops.flash_attention import (attention_reference, flash_attention,
                                   flash_attention_rope, make_rope_tables)
from ..ops.flash_decode import (aligned_cache_length, chunk_attention_reference,
                                decode_attention)
from ..ops.layer_norm import layer_norm
from ..ops.paged_attention import paged_chunk_attention, paged_decode_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEQ_AXIS = "seq"
_UNIFORM_WINDOW = object()  # _attend's default: "the model-wide window"


def glorot(rng: np.random.Generator, *shape: int, dtype=np.float32) -> np.ndarray:
    """Glorot-uniform over the trailing two dims (leading dims stack); a
    copy of ``elephas_tpu.parallel.param_utils.glorot`` so both packages
    draw bitwise-equal weights from one seed."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, size=shape).astype(dtype)


# -- the counter-based sampler -------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 tensors holding uint32 values, split in
    16-bit halves so no intermediate leaves the int64 range."""
    return ((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c & _M32


def _mix32(x):
    """A 32-bit integer finaliser (lowbias32): a bijection whose output bits
    each depend on every input bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _gumbel(seeds, out_pos, vocab: int):
    """Gumbel noise ``[S, vocab]`` that is a function of ``(seed, position,
    token id)`` alone: a counter-based generator computed with tensor ops on
    the logits' device, so sampling needs no host round trip."""
    s = seeds.to(torch.int64)
    key = _mix32((s & _M32) ^ _mix32((s >> 32) & _M32))
    key = _mix32(key ^ (out_pos.to(torch.int64) & _M32))
    ids = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    bits = _mix32(_mix32(key[:, None] ^ _mul32(ids, 0x9E3779B9)[None, :]))
    # 23 bits: (2**23 - 0.5) is still exact in float32, so u < 1
    u = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def select_slot_tokens(logits, out_pos, temps, seeds,
                       sampled: Optional[bool] = None):
    """Per-slot token selection for the serving engine: row ``i`` of
    ``logits`` ``[S, V]`` is greedy iff ``temps[i] <= 0``, else sampled from
    ``softmax(logits_i / temps_i)`` by the Gumbel-max rule with noise from
    ``(seeds[i], out_pos[i])``. ``out_pos`` is the absolute position the
    emitted token will occupy, so a request's draws are a function of
    ``(seed, position)`` alone: the same request produces the same tokens
    whatever slot it lands in and whatever else is co-batched.

    The draws differ from the reference's ``jax.random`` draws (another
    generator; the contract, not the bits, is what is ported). ``sampled``
    says whether any row samples; the engine knows it on the host, and
    ``None`` reads it from ``temps`` (a device sync). An all-greedy batch
    skips the noise."""
    greedy = logits.argmax(dim=-1)
    if sampled is None:
        sampled = bool((temps > 0).any())
    if not sampled:
        return greedy
    scaled = logits.to(torch.float32) / temps.clamp_min(1e-6)[:, None]
    drawn = (scaled + _gumbel(seeds, out_pos, logits.shape[-1])).argmax(dim=-1)
    return torch.where(temps > 0, drawn, greedy)


def spec_round_accept(pt, pd_draft, d_toks, u):
    """One speculative round's acceptance math (the distribution-preserving
    rejection rule) as a pure tensor function → ``(n, resid)``.

    ``pt`` ``[B, k+1, V]`` target probabilities over the verify chunk,
    ``pd_draft`` ``[B, k, V]`` the draft's proposal distributions,
    ``d_toks`` ``[B, k]`` the proposals, ``u`` ``[B, k]`` the acceptance
    uniforms. Proposal ``i`` is accepted while ``u_i < min(1,
    p_t(d_i)/p_d(d_i))``; ``n`` ``[B]`` is the accepted-prefix length and
    ``resid`` ``[B, V]`` the distribution the correction token is drawn
    from: the clamped normalised residual ``(p_t − p_d)+`` at the first
    rejection, or, with ``p_d`` padded by a zero row at index ``k``, the
    target's own distribution after a fully accepted round."""
    B, k = d_toks.shape
    pd = torch.cat([pd_draft, pd_draft.new_zeros((B, 1, pt.shape[-1]))], dim=1)
    idx = d_toks.to(torch.int64)[..., None]
    pt_d = pt[:, :k].gather(-1, idx)[..., 0]
    pd_d = pd[:, :k].gather(-1, idx)[..., 0]
    ratio = pt_d / pd_d.clamp_min(1e-20)
    accept = (u < ratio.clamp(max=1.0)).to(torch.int64)
    n = accept.cumprod(dim=1).sum(dim=1)
    at = n[:, None, None].expand(B, 1, pt.shape[-1])
    ptn, pdn = pt.gather(1, at)[:, 0], pd.gather(1, at)[:, 0]
    resid = (ptn - pdn).clamp_min(0.0)
    z = resid.sum(dim=-1, keepdim=True)
    return n, torch.where(z > 0, resid / z.clamp_min(1e-30), ptn)


def spec_verify_select(logits, drafts, pos, temps, seeds,
                       sampled: Optional[bool] = None):
    """The serving engine's speculative accept/select over one verify
    chunk: ``logits`` ``[S, C, V]`` (``C = K+1``: the carry and ``K``
    drafts scored by one chunk forward), ``drafts`` ``[S, K]``, ``pos``
    ``[S]`` each row's carry position, ``temps``/``seeds`` the per-slot
    selection state → ``(sel [S, C] int64, n [S] int64)``.

    ``sel[:, j]`` is :func:`select_slot_tokens` of ``logits[:, j]`` at
    output position ``pos + 1 + j``, the token the sequential engine would
    emit there, and a draft is accepted while it matches: ``n = Σ
    cumprod(sel[:, :K] == drafts)``. The correction at the stop slot is
    ``sel[:, n]``, so the emitted prefix ``sel[:, :n+1]`` is the sequential
    stream, greedy and sampled alike: this is :func:`spec_round_accept`'s
    rule for a deterministic proposal, coupled to the engine's ``(seed,
    position)``-keyed draws. The reference takes PRNG keys; the port takes
    the engine's seeds and its ``sampled`` flag, as
    :func:`select_slot_tokens` does. The ``S·C`` rows are selected in one
    call: the rule is row-wise, so this equals ``C`` calls bit for bit."""
    S, C, V = logits.shape
    K = drafts.shape[1]
    out_pos = (pos.to(torch.int64)[:, None] + 1
               + torch.arange(C, device=logits.device)[None, :])
    sel = select_slot_tokens(
        logits.reshape(S * C, V), out_pos.reshape(-1),
        temps.repeat_interleave(C), seeds.repeat_interleave(C),
        sampled).reshape(S, C)
    match = (sel[:, :K] == drafts.to(sel.dtype)).to(torch.int64)
    return sel, match.cumprod(dim=1).sum(dim=1)


def _spec_probs(logits_row, temperature: float):
    """Host-side softmax in float64 (the host loops' acceptance math)."""
    x = np.asarray(logits_row, np.float64) / temperature
    x -= x.max()
    e = np.exp(x)
    return e / e.sum()


def _spec_accept_row(vl_row, d_toks_row, d_probs_row, spec_k: int,
                     vocab: int, temperature: float, rng):
    """One row's speculative acceptance → ``(emitted tokens, n accepted)``,
    a copy of the reference's: ``vl_row`` ``[spec_k+1, V]`` target logits
    (numpy); greedy accepts while the target argmax agrees, sampled mode
    applies the rejection rule with the numpy ``rng`` (accept ``d`` w.p.
    ``min(1, p_t(d)/p_d(d))``, resample a rejection from ``(p_t − p_d)+``,
    the bonus from ``p_t``)."""
    if temperature <= 0.0:
        t_arg = vl_row.argmax(axis=-1)
        n = 0
        while n < spec_k and int(t_arg[n]) == int(d_toks_row[n]):
            n += 1
        return [int(x) for x in d_toks_row[:n]] + [int(t_arg[n])], n
    n = 0
    for i in range(spec_k):
        pt = _spec_probs(vl_row[i], temperature)
        pd = d_probs_row[i]
        d = int(d_toks_row[i])
        if rng.random() < min(1.0, pt[d] / max(pd[d], 1e-20)):
            n += 1
            continue
        resid = np.maximum(pt - pd, 0.0)
        z = resid.sum()
        resid = resid / z if z > 0 else pt
        return ([int(x) for x in d_toks_row[:n]]
                + [int(rng.choice(vocab, p=resid))], n)
    return ([int(x) for x in d_toks_row]
            + [int(rng.choice(vocab,
                              p=_spec_probs(vl_row[spec_k], temperature)))],
            n)


def _row_seeds(seed: int, rows):
    """Per-row generator seeds: ``seed`` in the high 32 bits, the row index
    in the low, so a row's draws depend on ``(seed, row)`` alone."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | rows.to(torch.int64)


def nucleus_mask(logits, top_p: float):
    """Boolean keep-mask of the top-p nucleus, per row of ``[B, V]`` logits:
    a token is kept iff the probability mass sorted before it is still
    ``< top_p`` (so the argmax always survives). The mask is scattered back
    through the sort permutation, so a boundary logit's duplicates outside
    the prefix are cut by rank, as in the reference (a stable ascending
    sort, reversed)."""
    sort_ix = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    probs = torch.softmax(logits.gather(-1, sort_ix).to(torch.float32), dim=-1)
    keep = (probs.cumsum(dim=-1) - probs) < float(top_p)
    return torch.zeros_like(keep).scatter(-1, sort_ix, keep)


def select_tokens(logits, seed: int, position, temperature: float = 0.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None,
                  row_offset: int = 0):
    """The generation sampling rule: greedy at ``temperature <= 0``;
    otherwise sample ``softmax(logits / temperature)`` restricted by top-k,
    then by the top-p nucleus (the most probable token always survives).
    ``logits`` ``[B, V]`` → ``[B]`` int64.

    Row ``i`` draws by the Gumbel-max rule with noise keyed by ``(seed,
    row_offset + i, position)``, ``position`` being the absolute position
    the token will occupy (an int or ``[B]`` tensor): a counter-based
    generator on the logits' device, so a draw needs no host sync and a
    row's tokens do not depend on its batch neighbours. The draws differ
    from the reference's ``jax.random`` draws (another generator; the
    distribution and the keying contract are what is ported)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = logits.to(torch.float32) / float(temperature)
    if top_k is not None:
        kth = torch.topk(scaled, int(top_k), dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_p is not None and float(top_p) < 1.0:
        scaled = scaled.masked_fill(~nucleus_mask(scaled, float(top_p)),
                                    float("-inf"))
    B, V = scaled.shape
    rows = row_offset + torch.arange(B, device=scaled.device)
    pos, _ = _positions(position, B, scaled.device)
    return (scaled + _gumbel(_row_seeds(seed, rows), pos, V)).argmax(dim=-1)


# -- losses ----------------------------------------------------------------------


def _summed_xent(logits, targets):
    """Summed next-token cross-entropy ``Σ (logsumexp - logit_at_target)``
    by max/lse (the ``[B, T, V]`` log-probabilities never exist)."""
    m = logits.amax(dim=-1).detach()
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    at = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - at).sum()


class _ChunkedXent(torch.autograd.Function):
    """:func:`chunked_summed_xent`: an online logsumexp over vocab blocks
    forward; the backward recomputes each block's logits from the saved
    lse and emits ``(softmax - onehot) @ wᵀ`` and ``hᵀ @ (softmax -
    onehot)`` block by block. Plain PyTorch, float32."""

    @staticmethod
    def forward(ctx, h, w, targets, block):
        hf = h.to(torch.float32)
        m = torch.full(targets.shape, float("-inf"), device=h.device)
        s = torch.zeros(targets.shape, device=h.device)
        at = torch.zeros(targets.shape, device=h.device)
        for off in range(0, w.shape[1], block):
            logits = hf @ w[:, off:off + block].to(torch.float32)
            width = logits.shape[-1]
            nm = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - nm) + torch.exp(logits - nm[..., None]).sum(-1)
            t_off = targets - off
            inb = (t_off >= 0) & (t_off < width)
            got = logits.gather(-1, t_off.clamp(0, width - 1)[..., None])[..., 0]
            at = at + torch.where(inb, got, torch.zeros_like(got))
            m = nm
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.block = block
        return (lse - at).sum()

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lse = ctx.saved_tensors
        hf = h.to(torch.float32)
        h2 = hf.reshape(-1, h.shape[-1])
        dh = torch.zeros_like(hf)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for off in range(0, w.shape[1], ctx.block):
            wb = w[:, off:off + ctx.block].to(torch.float32)
            p = torch.exp(hf @ wb - lse[..., None])
            cols = torch.arange(p.shape[-1], device=p.device)
            q = p - (cols == (targets - off)[..., None]).to(torch.float32)
            dh = dh + q @ wb.T
            dw[:, off:off + ctx.block] = h2.T @ q.reshape(-1, q.shape[-1])
        return (g * dh).to(h.dtype), (g * dw).to(w.dtype), None, None


def chunked_summed_xent(h, w, targets, block: int = 8192):
    """:func:`_summed_xent` over ``logits = h @ w`` without materialising
    ``[B, T, V]``: the head streams in ``block``-column chunks forward and
    backward. ``h`` ``[..., D]``, ``w`` ``[D, V]`` (``params["tok"].T`` for
    tied embeddings; autograd carries the gradient back through the
    transpose), integer ``targets`` shaped like ``h``'s leading dims.
    Returns the summed cross-entropy."""
    return _ChunkedXent.apply(h, w, _as_index(targets, h.device), int(block))


# -- rematerialisation ---------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep matmul outputs, recompute the rest
    (the reference's ``checkpoint_dots``)."""
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, remat: str):
    """The per-layer remat policy: ``"none"`` stores every residual,
    ``"dots"`` saves matmul outputs and recomputes the elementwise, norm
    and attention work, ``"full"`` recomputes the whole block from its
    input in the backward."""
    if remat == "none":
        return fn
    if remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_save_dots))
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"Unknown remat policy: {remat!r} (none|dots|full)")


# -- cache helpers ---------------------------------------------------------------


def write_prompt_cache(kc, vc, ks, vs, windowed: bool):
    """Prompt K/V ``ks``/``vs`` ``[..., T0, Dh]`` (the reference's ``[L, B,
    H, T0, Dh]``, or one layer's ``[B, H, T0, Dh]``) into the cache
    ``kc``/``vc`` ``[..., Tc, Dh]`` at positions ``0..T0-1``: the single
    home of the ring-write convention. A rolling cache (``windowed``) keeps
    only the prompt's last ``Tc`` positions, position ``p`` in slot ``p mod
    Tc``; a shorter prompt takes the contiguous write, where ``p mod Tc ==
    p``. The write lands in place (the reference returns new buffers that
    XLA writes in place); ``(kc, vc)`` are returned as the reference
    returns them. A linear cache shorter than the prompt raises, where the
    reference's ``dynamic_update_slice`` clamps silently."""
    T0, Tc = ks.shape[-2], kc.shape[-2]
    if windowed and T0 > Tc:
        slots = torch.arange(T0 - Tc, T0, device=kc.device) % Tc
        dim = kc.dim() - 2
        kc.index_copy_(dim, slots, ks[..., T0 - Tc:, :].to(kc.dtype))
        vc.index_copy_(dim, slots, vs[..., T0 - Tc:, :].to(vc.dtype))
        return kc, vc
    if T0 > Tc:
        raise ValueError(f"prompt of {T0} tokens does not fit a cache of {Tc}")
    kc[..., :T0, :] = ks
    vc[..., :T0, :] = vs
    return kc, vc


def _adapter_ctx(model, rows):
    """Enter ``model``'s per-row adapter context when it has one
    (:class:`~elephas_tpu_torch.models.lora.MultiTenantLM`: ``rows`` selects
    each batch row's adapter in every ``_attn_proj`` run inside the
    context); a plain model gets a no-op, so one code path serves both."""
    ctx = getattr(model, "adapter_context", None)
    if ctx is None:
        return contextlib.nullcontext()
    return ctx(rows)


def cache_gather_slot(cache, slot: int):
    """Batch row ``slot`` of a KV cache ``{"k"/"v": [L, B, Hkv, T, Dh]}`` as
    the same dict with ``B == 1``. The rows are VIEWS, so writes into them
    land in ``cache`` itself."""
    return {n: c[:, slot:slot + 1] for n, c in cache.items()}


def cache_scatter_slot(cache, slot: int, slot_cache):
    """Write the ``B == 1`` slice ``slot_cache`` into row ``slot`` of
    ``cache``; a slice that is already a view of that row (from
    :func:`cache_gather_slot`) holds its writes and is not copied."""
    for n, c in cache.items():
        dst = c[:, slot:slot + 1]
        if dst.data_ptr() != slot_cache[n].data_ptr():
            dst.copy_(slot_cache[n])
    return cache


def _cache_update_rows(cache, new, pos, per_row: bool):
    """Write ``new`` ``[B, Hkv, S, Dh]`` into ``cache`` ``[B, Hkv, T, Dh]``
    IN PLACE at time offset ``pos``: one shared offset (a Python int, or a
    0-d tensor) or one per row (``[B]``). The reference returns a new buffer
    that XLA writes in place because the cache is donated; here the write
    is explicit. ``pos + S <= T`` must hold (the serving cache guarantees
    it); unlike the reference's ``dynamic_update_slice`` nothing is
    clamped."""
    S = new.shape[2]
    if not per_row and not torch.is_tensor(pos):
        cache[:, :, int(pos):int(pos) + S] = new
        return cache
    rows = torch.as_tensor(pos, device=cache.device).to(torch.int64).reshape(-1, 1)
    return _scatter_rows(cache, new, rows + torch.arange(S, device=cache.device))


def _scatter_rows(cache, new, slots):
    """Write ``new`` ``[B, Hkv, S, Dh]`` into ``cache`` ``[B, Hkv, T, Dh]``
    IN PLACE, row ``b``'s position ``s`` at time slot ``slots[b, s]``
    (``[B, S]``, or ``[1, S]`` for every row; ``pos mod T`` on a rolling
    cache), as one scatter along T."""
    idx = slots.to(torch.int64)[:, None, :, None]
    return cache.scatter_(2, idx.expand(new.shape), new)


def _rope_angles(positions, dh: int, theta: float = 10000.0):
    """RoPE angles for absolute ``positions`` ``[...]`` → ``(cos, sin)``
    each ``[..., dh/2]`` (frequency base ``theta``)."""
    half = dh // 2
    inv_freq = torch.pow(float(theta), -torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def _rope_rotate(x, cos, sin):
    """Rotate head vectors ``x`` ``[..., H, Dh]`` by ``cos``/``sin``
    ``[..., 1, Dh/2]``; half-split (NeoX-style) pairing, dim ``i`` with dim
    ``i + Dh/2``, as the reference."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _positions(pos, rows: int, device) -> Tuple[torch.Tensor, bool]:
    """``pos`` (int, 0-d or ``[B]`` tensor) → ``(int64 [rows] tensor,
    per_row)`` on ``device``, without a host sync."""
    if torch.is_tensor(pos):
        per_row = pos.dim() == 1
        return pos.to(device=device, dtype=torch.int64).reshape(-1).expand(rows), per_row
    return torch.full((rows,), int(pos), dtype=torch.int64, device=device), False


class TransformerLM(nn.Module):
    """Decoder-only LM: embed → L pre-norm blocks (attn + FFN) → norm → head,
    the reference's ``TransformerLM`` for serving. ``device`` is where
    :meth:`init` and :meth:`init_cache` put their tensors (default
    ``"cuda"``; raises without CUDA unless ``"cpu"`` is asked for)."""

    _supports_speculative = True

    def __init__(self, vocab: int, d_model: int, n_heads: int, n_layers: int,
                 d_ff: int, max_len: int, compute_dtype: str = "float32",
                 pos_encoding: str = "learned", tie_embeddings: bool = False,
                 n_kv_heads: Optional[int] = None, activation: str = "relu",
                 norm: str = "layernorm", norm_eps: float = 1e-5,
                 attn_bias: bool = False, ffn_bias: bool = True,
                 rope_theta: float = 10000.0,
                 attn_window: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by {n_heads} heads")
        n_kv_heads = n_heads if n_kv_heads is None else int(n_kv_heads)
        if n_kv_heads < 1 or n_heads % n_kv_heads:
            raise ValueError(
                f"n_heads {n_heads} not divisible by n_kv_heads {n_kv_heads}")
        if pos_encoding not in ("learned", "rotary"):
            raise ValueError(f"Unknown pos_encoding: {pos_encoding}")
        if pos_encoding == "rotary" and (d_model // n_heads) % 2:
            raise ValueError(
                f"rotary needs an even head dim, got {d_model // n_heads}")
        if activation not in ("relu", "gelu", "swiglu"):
            raise ValueError(f"Unknown activation: {activation}")
        if norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"Unknown norm: {norm}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"Unknown compute_dtype: {compute_dtype}")
        # sliding-window attention (the Mistral convention: query t sees
        # keys (t - window, t]); one window for every layer, or a
        # length-n_layers sequence of int/None (Gemma-2's alternation,
        # Qwen2's layer_types)
        if attn_window is None or isinstance(attn_window, (int, np.integer)):
            if attn_window is not None and int(attn_window) < 1:
                raise ValueError(
                    f"attn_window must be >= 1, got {attn_window}")
            uniform = None if attn_window is None else int(attn_window)
            self.attn_windows = (uniform,) * n_layers
        else:
            ws = tuple(None if w is None else int(w) for w in attn_window)
            if len(ws) != n_layers:
                raise ValueError(
                    f"per-layer attn_window needs {n_layers} entries, "
                    f"got {len(ws)}")
            if any(w is not None and w < 1 for w in ws):
                raise ValueError(f"attn_window entries must be >= 1: {ws}")
            self.attn_windows = ws
        self.mixed_window = len(set(self.attn_windows)) > 1
        # the uniform view, None for a mixed model: a caller that cannot
        # take per-layer windows guards on mixed_window
        self.attn_window = None if self.mixed_window else self.attn_windows[0]
        # the decode cache rolls only when EVERY layer is windowed (one
        # full-attention layer needs the horizon anyway); a mixed
        # all-windowed model shares one ring sized to its largest window
        self._ring_cache = all(w is not None for w in self.attn_windows)
        self._max_window = max((w for w in self.attn_windows
                                if w is not None), default=None)
        self.device = resolve_device(device)
        self.vocab = vocab
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.n_layers = n_layers
        self.d_ff = d_ff
        self.max_len = max_len
        self.pos_encoding = pos_encoding
        self.activation = activation
        self.norm = norm
        self.norm_eps = float(norm_eps)
        self.attn_bias = bool(attn_bias)
        self.ffn_bias = bool(ffn_bias)
        self.rope_theta = float(rope_theta)
        self.tie_embeddings = bool(tie_embeddings)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.aux_weight = 0.0  # the MoE variant weighs its aux loss

    # -- parameters ---------------------------------------------------------
    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Name → shape of every parameter (all float32), in the
        reference's order, which fixes the order of :meth:`init`'s draws."""
        V, D, L, F_, T = (self.vocab, self.d_model, self.n_layers, self.d_ff,
                          self.max_len)
        Dkv = (D // self.n_heads) * self.n_kv_heads
        shapes = {
            "tok": (V, D),
            "ln1_s": (L, D), "ln1_b": (L, D),
            "wq": (L, D, D),
            "wk": (L, D, Dkv),
            "wv": (L, D, Dkv),
            "wo": (L, D, D),
            "ln2_s": (L, D), "ln2_b": (L, D),
            "w1": (L, D, F_), "b1": (L, F_),
            "w2": (L, F_, D), "b2": (L, D),
            "lnf_s": (D,), "lnf_b": (D,),
        }
        if self.norm == "rmsnorm":  # rmsnorm is scale-only
            for k in ("ln1_b", "ln2_b", "lnf_b"):
                del shapes[k]
        if self.activation == "swiglu":
            shapes["w3"] = (L, D, F_)
        if not self.ffn_bias:
            for k in ("b1", "b2"):
                del shapes[k]
        if self.attn_bias:
            shapes["bq"] = (L, D)
            shapes["bk"] = (L, Dkv)
            shapes["bv"] = (L, Dkv)
            shapes["bo"] = (L, D)
        if not self.tie_embeddings:
            shapes["head"] = (D, V)
        if self.pos_encoding == "learned":
            shapes["pos"] = (T, D)
        return shapes

    def init(self, seed: int = 0,
             device: Optional[DeviceLike] = None) -> Dict[str, torch.Tensor]:
        """Random weights from ``seed``: the reference's numpy draws in the
        reference's order, so both packages get bitwise-equal weights from
        one seed. Tensors land on ``device`` (default: the model's)."""
        dev = self.device if device is None else resolve_device(device)
        rng = np.random.default_rng(seed)
        out: Dict[str, np.ndarray] = {}
        for name, shape in self.param_shapes().items():
            if name.startswith(("ln1_s", "ln2_s", "lnf_s")):
                out[name] = np.ones(shape, np.float32)
            elif name.startswith(("ln", "b")):
                out[name] = np.zeros(shape, np.float32)
            elif name in ("tok", "pos"):
                out[name] = (rng.normal(size=shape) * 0.02).astype(np.float32)
            else:
                out[name] = glorot(rng, *shape, dtype=np.float32)
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}

    def _block_keys(self):
        keys = ["ln1_s", "wq", "wk", "wv", "wo", "ln2_s", "w1", "w2"]
        if self.norm == "layernorm":
            keys += ["ln1_b", "ln2_b"]
        if self.ffn_bias:
            keys += ["b1", "b2"]
        if self.activation == "swiglu":
            keys += ["w3"]
        if self.attn_bias:
            keys += ["bq", "bk", "bv", "bo"]
        return tuple(keys)

    # -- block pieces -------------------------------------------------------
    def head_weight(self, params):
        """The ``[D, V]`` logits matrix (the transposed token embedding
        under ``tie_embeddings``)."""
        return params["tok"].T if self.tie_embeddings else params["head"]

    def _logits(self, params, h):
        return h @ self.head_weight(params)

    def _embed(self, params, tokens, positions):
        """Token (+ learned-position) embedding in the compute dtype. A
        position past ``max_len - 1`` reads the last learned row, as the
        reference's gather clamps: speculative rounds near the horizon
        score chunk rows there (a frozen row, a rejected tail) whose
        outputs are never used, and an index past the table would raise
        on the CPU and fault the card."""
        h = params["tok"][tokens]
        if self.pos_encoding == "learned":
            h = h + params["pos"][positions.clamp(max=self.max_len - 1)]
        return h.to(self.compute_dtype)

    def _norm_h(self, lp, prefix: str, x):
        """Pre/post-block normalisation in float32: layernorm (the fused
        kernel on the card) or scale-only rmsnorm."""
        x32 = x.to(torch.float32)
        s = lp[prefix + "_s"]
        if self.norm == "rmsnorm":
            ms = x32.square().mean(dim=-1, keepdim=True)
            return x32 * torch.rsqrt(ms + self.norm_eps) * s
        return layer_norm(x32, s, lp[prefix + "_b"], self.norm_eps)

    def _attn_proj(self, lp, name: str, x):
        """``x @ w<name>`` (+ ``b<name>`` under ``attn_bias``) in ``x``'s
        dtype."""
        y = x @ lp["w" + name].to(x.dtype)
        if self.attn_bias:
            y = y + lp["b" + name].to(x.dtype)
        return y

    def _ffn(self, lp, x, attn: str = "dense", ep_groups: Optional[int] = None):
        """Per-block FFN → ``(residual delta, aux loss)``; the aux is 0.0
        here. The MoE variant routes through experts and uses ``attn`` and
        ``ep_groups`` to pick its dispatch groups (decode passes 1)."""
        del attn, ep_groups
        cd = x.dtype
        u = x @ lp["w1"].to(cd)
        if self.ffn_bias:
            u = u + lp["b1"].to(cd)
        if self.activation == "swiglu":
            u = F.silu(u) * (x @ lp["w3"].to(cd))
        elif self.activation == "gelu":
            # tanh approximation == HF's gelu_new (what GPT-2 trained with)
            u = F.gelu(u, approximate="tanh")
        else:
            u = F.relu(u)
        out = u @ lp["w2"].to(cd)
        if self.ffn_bias:
            out = out + lp["b2"].to(cd)
        return out, 0.0

    def _rope_for(self, positions):
        """``(cos, sin)`` shaped ``[B, T, 1, Dh/2]`` for rotary models, else
        ``None``."""
        if self.pos_encoding != "rotary":
            return None
        cos, sin = _rope_angles(positions, self.d_model // self.n_heads,
                                self.rope_theta)
        return cos[:, :, None, :], sin[:, :, None, :]

    def _layer(self, params, l: int):
        return {k: params[k][l] for k in self._block_keys()}

    def _window_period(self) -> int:
        """Minimal period ``p`` (dividing L) over which the per-layer window
        pattern tiles: 1 for a uniform model, 2 for an alternation, L for an
        aperiodic pattern. The reference scans its layers in groups of
        ``p``; the port loops over the layers, each with its own window,
        and keeps this for the same answer."""
        ws, L = self.attn_windows, self.n_layers
        for p in range(1, L + 1):
            if L % p == 0 and ws == ws[:p] * (L // p):
                return p
        return L

    # -- autoregressive inference (KV cache) ---------------------------------
    def init_cache(self, batch: int, length: Optional[int] = None,
                   chunk: int = 1) -> Dict[str, torch.Tensor]:
        """Zeroed KV cache ``{"k"/"v": [L, B, Hkv, T, Dh]}`` on the model's
        device, ``T`` = ``length`` (default ``max_len``) rounded up as the
        reference rounds it, so both packages allocate the same shapes.

        A model whose every layer is windowed gets a ROLLING buffer: ``T``
        is ``min(length, largest window) + chunk`` (rounded up), so memory
        stays O(window) however long the rollout; position ``p`` writes
        slot ``p mod T`` and the decode paths mask by slot age. ``chunk``
        is the largest block :meth:`decode_chunk` will write per call
        (``spec_k + 1`` for speculative decoding): the extra slots keep a
        chunk's writes from clobbering positions its own earlier queries
        still attend, and make the buffer strictly larger than the window,
        which tells a clamped ring from a horizon-bounded one. A linear
        cache keeps its shape whatever ``chunk``."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        T_req = self.max_len if length is None else length
        if self._ring_cache:
            T_req = min(T_req, self._max_window) + int(chunk)
        T = aligned_cache_length(T_req)
        shape = (self.n_layers, batch, self.n_kv_heads, T,
                 self.d_model // self.n_heads)
        return {"k": torch.zeros(shape, dtype=self.compute_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.compute_dtype, device=self.device)}

    def decode_step(self, params, token, pos, cache):
        """One cached decode step: ``token`` ``[B]`` at absolute position
        ``pos`` (int, or per-row ``[B]`` tensor) → ``(logits [B, V],
        cache)``. Writes each layer's K/V at ``pos`` (``pos mod T`` in a
        rolling cache) in place, then attends over cache positions
        ``0..pos``, cut to the layer's window, with the flash-decode kernel
        (its plain version on the CPU)."""
        B = token.shape[0]
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        cd = self.compute_dtype
        ring = self._ring_cache
        pos_b, per_row = _positions(pos, B, token.device)
        pos32 = pos_b.to(torch.int32)   # the kernel's index type, cast once
        widx = pos
        if ring:
            widx, per_row = torch.remainder(pos_b, cache["k"].shape[3]), True
        h = self._embed(params, token, pos_b)  # [B, D]
        if self.pos_encoding == "rotary":
            r_cos, r_sin = _rope_angles(pos_b, Dh, self.rope_theta)
            r_cos, r_sin = r_cos[:, None, :], r_sin[:, None, :]
        for l in range(self.n_layers):
            lp = self._layer(params, l)
            kc, vc = cache["k"][l], cache["v"][l]
            x = self._norm_h(lp, "ln1", h).to(cd)
            q = self._attn_proj(lp, "q", x).reshape(B, H, Dh)
            k_new = self._attn_proj(lp, "k", x).reshape(B, Hkv, 1, Dh)
            v_new = self._attn_proj(lp, "v", x).reshape(B, Hkv, 1, Dh)
            if self.pos_encoding == "rotary":
                # the cache stores PRE-ROTATED keys (decode_chunk does too)
                q = _rope_rotate(q, r_cos, r_sin)
                k_new = _rope_rotate(k_new, r_cos[:, None], r_sin[:, None])
            _cache_update_rows(kc, k_new, widx, per_row)
            _cache_update_rows(vc, v_new, widx, per_row)
            # grouped attention straight against the Hkv-head cache: query
            # head h = kv_head * G + g
            qg = q.reshape(B, Hkv, H // Hkv, Dh)
            a = decode_attention(qg, kc, vc, pos32, window=self.attn_windows[l],
                                 ring=ring).to(cd)
            h = h + self._attn_proj(lp, "o", a.reshape(B, self.d_model))
            x = self._norm_h(lp, "ln2", h).to(cd)
            out, _ = self._ffn(lp, x[:, None, :], "dense", ep_groups=1)
            h = h + out[:, 0].to(cd)
        h = self._norm_h(params, "lnf", h)
        return self._logits(params, h), cache

    def decode_chunk(self, params, tokens, pos0, cache):
        """Cached forward over a block of ``S`` tokens at absolute
        positions ``pos0..pos0+S-1`` (``pos0`` an int or per-row ``[B]``
        tensor) → ``(logits [B, S, V], cache)``. Writes the chunk's K/V in
        place first, then attends each query against cache positions
        ``0..its own position``, cut to the layer's window — so a chunk
        starting at the first stale position also repairs it. The
        attention is a plain masked softmax over the whole cache, as in the
        reference.

        A rolling cache writes each row's positions at ``pos mod T`` and
        masks by slot age, ``(pos - slot) mod T < min(window, pos + 1)``; it
        must have been allocated with ``init_cache(..., chunk >= S)``: the
        margin keeps a chunk's later writes out of the slots its earlier
        queries attend. A window-clamped ring without it raises."""
        B, S = tokens.shape
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        G = H // Hkv
        cd = self.compute_dtype
        dev = tokens.device
        T = cache["k"].shape[3]
        ring = self._ring_cache
        if ring and S > 1:
            for w in set(self.attn_windows):
                if w < T < w + S - 1:
                    raise ValueError(
                        f"ring cache ({T} slots, window {w}) cannot take "
                        f"{S}-token chunks; allocate with "
                        f"init_cache(..., chunk={S}) or larger")
        base, _ = _positions(pos0, B, dev)
        pos_b = base[:, None] + torch.arange(S, device=dev)[None, :]   # [B, S]
        slots = torch.remainder(pos_b, T) if ring else pos_b
        h = self._embed(params, tokens, pos_b)  # [B, S, D]
        rope = self._rope_for(pos_b)
        for l in range(self.n_layers):
            lp = self._layer(params, l)
            kc, vc = cache["k"][l], cache["v"][l]
            x = self._norm_h(lp, "ln1", h).to(cd)
            q = self._attn_proj(lp, "q", x).reshape(B, S, H, Dh)
            k_new = self._attn_proj(lp, "k", x).reshape(B, S, Hkv, Dh)
            v_new = self._attn_proj(lp, "v", x).reshape(B, S, Hkv, Dh)
            if rope is not None:
                q = _rope_rotate(q, *rope)
                k_new = _rope_rotate(k_new, *rope)
            _scatter_rows(kc, k_new.transpose(1, 2), slots)
            _scatter_rows(vc, v_new.transpose(1, 2), slots)
            qg = q.transpose(1, 2).reshape(B, Hkv, G, S, Dh)
            a = chunk_attention_reference(qg, kc, vc, pos_b,
                                          self.attn_windows[l], ring).to(cd)
            a = a.reshape(B, H, S, Dh).transpose(1, 2)
            h = h + self._attn_proj(lp, "o", a.reshape(B, S, self.d_model))
            x = self._norm_h(lp, "ln2", h).to(cd)
            out, _ = self._ffn(lp, x, "dense", ep_groups=1)
            h = h + out.to(cd)
        h = self._norm_h(params, "lnf", h)
        return self._logits(params, h), cache

    def prefill_slot(self, params, tokens, slot: int, cache, pos0=0):
        """Prompt ingestion into ONE batch row of a multi-slot cache:
        :meth:`decode_chunk` over ``tokens`` ``[1, T0]`` at positions
        ``pos0..pos0+T0-1`` against row ``slot`` of ``cache`` →
        ``(logits [1, T0, V], cache)``; no other row is touched. ``pos0 >
        0`` continues a chunked prefill. ``tokens`` may be right-padded past
        the real prompt: pad positions write K/V that this request's own
        decode writes overwrite before any query attends them, and their
        logits must not be sampled from. A rolling (all-windowed) cache is
        refused, as in the reference: its chunk margin is per rollout, not
        per slot."""
        if self._ring_cache:
            raise NotImplementedError(
                "prefill_slot needs a linear (horizon) cache; all-windowed "
                "models allocate rolling buffers — serve those with at "
                "least one full-attention layer, or without slot batching")
        slot_cache = cache_gather_slot(cache, slot)
        logits, slot_cache = self.decode_chunk(params, tokens, pos0, slot_cache)
        return logits, cache_scatter_slot(cache, slot, slot_cache)

    # -- paged KV pool -------------------------------------------------------
    def _page_rows(self, pos_b, table, page: int):
        """Pool rows written by absolute positions ``pos_b`` (``[B]`` or
        ``[B, S]`` int64) through ``table`` ``[B, M]``: one row id per
        (position, KV head) in a layer's pool viewed as ``[P·Hkv·page,
        Dh]``, ordered as the new K/V rows are. Positions past the table's
        ``M·page`` and unmapped cells both land in the trash page 0 (the
        reference's ``mode="drop"`` scatter has no torch counterpart, so the
        ids are built here and a write never leaves the pool). Computed once
        per call, shared by every layer."""
        M, Hkv = table.shape[1], self.n_kv_heads
        p2 = pos_b.reshape(pos_b.shape[0], -1)
        cell = torch.clamp(p2 // page, 0, M - 1)
        pids = torch.where(p2 < M * page, table.gather(1, cell).to(torch.int64),
                           torch.zeros_like(p2))
        heads = torch.arange(Hkv, device=pos_b.device)
        rows = (pids[..., None] * Hkv + heads) * page + (p2 % page)[..., None]
        return rows.reshape(-1)

    @staticmethod
    def _write_rows(pool_l, rows, new):
        """``new`` ``[..., Dh]`` into one layer's pool ``[P, Hkv, page, Dh]``
        at flat ``rows``, in place (one ``index_copy_``)."""
        dh = pool_l.shape[-1]
        pool_l.view(-1, dh).index_copy_(0, rows, new.reshape(-1, dh))

    def decode_step_paged(self, params, token, pos, pool, table, page: int):
        """One cached decode step straight over a paged KV pool: ``token``
        ``[B]`` at positions ``pos`` (int or per-row ``[B]``) against ``pool``
        ``{"k"/"v": [L, P, Hkv, page, Dh]}`` read through ``table`` ``[B, M]``
        int32 → ``(logits [B, V], pool)``. The layer body of
        :meth:`decode_step`, but each layer writes only the new K/V row into
        its owning page, in place, and attends through the table (the
        paged-attention kernel on the card; on the CPU the plain version,
        which keeps the logits bitwise equal to :meth:`decode_step` on the
        equivalent dense cache). Rows whose cell at the write position is
        unmapped (parked or free slots) write into the trash page. Each layer
        attends within its own window; rolling (all-windowed) caches have no
        paged layout and raise, as in the reference."""
        if self._ring_cache:
            raise ValueError(
                "decode_step_paged: paged pools are linear-horizon; "
                "rolling (all-windowed) caches have no paged layout")
        B = token.shape[0]
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        cd = self.compute_dtype
        pos_b, _ = _positions(pos, B, token.device)
        pos32 = pos_b.to(torch.int32)
        rows = self._page_rows(pos_b, table, page)
        h = self._embed(params, token, pos_b)  # [B, D]
        if self.pos_encoding == "rotary":
            r_cos, r_sin = _rope_angles(pos_b, Dh, self.rope_theta)
            r_cos, r_sin = r_cos[:, None, :], r_sin[:, None, :]
        for l in range(self.n_layers):
            lp = self._layer(params, l)
            kp, vp = pool["k"][l], pool["v"][l]
            x = self._norm_h(lp, "ln1", h).to(cd)
            q = self._attn_proj(lp, "q", x).reshape(B, H, Dh)
            k_new = self._attn_proj(lp, "k", x).reshape(B, Hkv, Dh)
            v_new = self._attn_proj(lp, "v", x).reshape(B, Hkv, Dh)
            if self.pos_encoding == "rotary":
                # pages store PRE-ROTATED keys, like the dense cache
                q = _rope_rotate(q, r_cos, r_sin)
                k_new = _rope_rotate(k_new, r_cos, r_sin)
            self._write_rows(kp, rows, k_new)
            self._write_rows(vp, rows, v_new)
            qg = q.reshape(B, Hkv, H // Hkv, Dh)
            a = paged_decode_attention(qg, kp, vp, table, pos32, page,
                                       self.attn_windows[l]).to(cd)
            h = h + self._attn_proj(lp, "o", a.reshape(B, self.d_model))
            x = self._norm_h(lp, "ln2", h).to(cd)
            out, _ = self._ffn(lp, x[:, None, :], "dense", ep_groups=1)
            h = h + out[:, 0].to(cd)
        h = self._norm_h(params, "lnf", h)
        return self._logits(params, h), pool

    def decode_chunk_paged(self, params, tokens, pos0, pool, table, page: int):
        """Cached forward of ``S`` tokens per row straight over a paged pool,
        the paged sibling of :meth:`decode_chunk` (paged prefill-insert,
        chunked-prefill continuations, prefix-adopted suffixes): ``tokens``
        ``[B, S]`` at positions ``pos0..pos0+S-1`` (``pos0`` an int or
        per-row ``[B]``) → ``(logits [B, S, V], pool)``. Each layer writes
        the chunk's own K/V rows into their pages in place (shared prefix
        pages are attended, never rewritten) and attends all queries through
        the table, each layer within its own window. Positions past the
        table's capacity or without a mapped page (bucket padding) write into
        the trash page. Rolling (all-windowed) caches raise, as in
        :meth:`decode_step_paged`."""
        if self._ring_cache:
            raise ValueError(
                "decode_chunk_paged: paged pools are linear-horizon; "
                "rolling (all-windowed) caches have no paged layout")
        B, S = tokens.shape
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        G = H // Hkv
        cd = self.compute_dtype
        dev = tokens.device
        base, _ = _positions(pos0, B, dev)
        pos_b = base[:, None] + torch.arange(S, device=dev)[None, :]   # [B, S]
        base32 = base.to(torch.int32)
        rows = self._page_rows(pos_b, table, page)
        h = self._embed(params, tokens, pos_b)  # [B, S, D]
        rope = self._rope_for(pos_b)
        for l in range(self.n_layers):
            lp = self._layer(params, l)
            kp, vp = pool["k"][l], pool["v"][l]
            x = self._norm_h(lp, "ln1", h).to(cd)
            q = self._attn_proj(lp, "q", x).reshape(B, S, H, Dh)
            k_new = self._attn_proj(lp, "k", x).reshape(B, S, Hkv, Dh)
            v_new = self._attn_proj(lp, "v", x).reshape(B, S, Hkv, Dh)
            if rope is not None:
                q = _rope_rotate(q, *rope)
                k_new = _rope_rotate(k_new, *rope)
            self._write_rows(kp, rows, k_new)
            self._write_rows(vp, rows, v_new)
            qg = q.transpose(1, 2).reshape(B, Hkv, G, S, Dh)
            a = paged_chunk_attention(qg, kp, vp, table, base32, page,
                                      self.attn_windows[l]).to(cd)
            a = a.reshape(B, H, S, Dh).transpose(1, 2)
            h = h + self._attn_proj(lp, "o", a.reshape(B, S, self.d_model))
            x = self._norm_h(lp, "ln2", h).to(cd)
            out, _ = self._ffn(lp, x, "dense", ep_groups=1)
            h = h + out.to(cd)
        h = self._norm_h(params, "lnf", h)
        return self._logits(params, h), pool

    # -- teacher-forced forward (training) ------------------------------------
    def _layers(self, params):
        """Per-layer views of the stacked ``[L, ...]`` params (``unbind``,
        whose backward stacks the layer gradients in one copy)."""
        keys = self._block_keys()
        return [dict(zip(keys, vals))
                for vals in zip(*(params[k].unbind(0) for k in keys))]

    def _attend(self, q, k, v, attn: str, rope_tables=None,
                window=_UNIFORM_WINDOW):
        """Causal attention over a full sequence: ``"dense"`` is the plain
        oracle (autograd through PyTorch ops), ``"flash"`` the
        flash-attention kernels on the card (their plain versions on the
        CPU). KV heads are never repeated on the flash path. With
        ``rope_tables`` q and k arrive unrotated and the rope-on-load
        kernels rotate them (``"flash"`` only).

        ``window`` is THIS layer's sliding window; left at its default it
        is the model's uniform window, and a mixed-window model raises: a
        caller not taught per-layer windows must fail, never attend
        unwindowed."""
        if window is _UNIFORM_WINDOW:
            if self.mixed_window:
                raise NotImplementedError(
                    "this attention path has no per-layer window support; "
                    "mixed attn_window models run the core single-device "
                    "family (apply/prefill/decode/generate) only")
            window = self.attn_window
        if attn == "dense":
            return attention_reference(q, k, v, causal=True, window=window)
        if attn == "flash":
            if rope_tables is not None:
                return flash_attention_rope(q, k, v, *rope_tables, True,
                                            window=window)
            return flash_attention(q, k, v, causal=True, window=window)
        if attn in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn={attn!r} needs sequence parallelism, not ported yet "
                "(ROADMAP.md queue 1, 'Parallel extensions')")
        raise ValueError(f"Unknown attn: {attn}")

    def _block_fwd(self, h, lp, attn: str, rope=None,
                   ep_groups: Optional[int] = None, rope_tables=None,
                   window=_UNIFORM_WINDOW):
        """One transformer block on ``h`` ``[B, T, D]``, the block math
        shared by the teacher-forced forward and :meth:`prefill`. Layernorm
        runs in float32, everything else in the compute dtype; under rotary
        positions q and k rotate by ``rope`` before attention, or, given
        ``rope_tables`` on the flash path, inside the attention kernels;
        either way the returned, cacheable k is rotated. ``window`` is the
        layer's sliding window (see :meth:`_attend`). ``attn`` and
        ``ep_groups`` reach :meth:`_ffn` too. Returns ``(h, aux, k, v)``
        with ``k``/``v`` ``[B, T, Hkv, Dh]``."""
        B, T = h.shape[0], h.shape[1]
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        cd = self.compute_dtype
        x = self._norm_h(lp, "ln1", h).to(cd)
        q = self._attn_proj(lp, "q", x).reshape(B, T, H, Dh)
        k = self._attn_proj(lp, "k", x).reshape(B, T, Hkv, Dh)
        v = self._attn_proj(lp, "v", x).reshape(B, T, Hkv, Dh)
        if rope_tables is not None:
            a = self._attend(q, k, v, attn, rope_tables, window).to(cd)
            k = _rope_rotate(k, *rope)
        else:
            if rope is not None:
                q = _rope_rotate(q, *rope)
                k = _rope_rotate(k, *rope)
            a = self._attend(q, k, v, attn, window=window).to(cd)
        h = h + self._attn_proj(lp, "o", a.reshape(B, T, self.d_model))
        x = self._norm_h(lp, "ln2", h).to(cd)
        out, aux = self._ffn(lp, x, attn, ep_groups)
        return h + out.to(cd), aux, k, v

    def apply_hidden(self, params, tokens, positions, attn: str = "dense",
                     seq_axis: str = SEQ_AXIS, grad_reduce=None,
                     remat: str = "none"):
        """The forward up to and including the final norm: ``tokens`` and
        ``positions`` (absolute) int ``[B, T]`` → ``(h [B, T, D], aux)``,
        ``aux`` the auxiliary loss summed over the layers (0 for the dense
        FFN, the load-balancing loss for MoE). Lets a
        large-vocab loss stream the head (:func:`chunked_summed_xent`).
        ``remat`` is the per-layer rematerialisation policy
        (``"none"|"dots"|"full"``). ``seq_axis`` names the sequence axis
        of a sharded run and is unused on one device; ``grad_reduce``
        (per-layer gradient collectives) is not ported yet and must be
        ``None``. A rotary model on ``attn="flash"`` builds its rope
        tables once here and runs the rope-on-load kernels. Each layer
        attends within its own window (``attn_windows``)."""
        if grad_reduce is not None:
            raise NotImplementedError(
                "grad_reduce tags per-layer gradient collectives across "
                "devices, not ported yet (ROADMAP.md queue 1 item 6, "
                "'Speculation and sharding')")
        dev = params["tok"].device
        tokens, positions = _as_index(tokens, dev), _as_index(positions, dev)
        h = self._embed(params, tokens, positions)
        rope = self._rope_for(positions)
        tables = None
        if rope is not None and attn == "flash":
            cos, sin = rope
            tables = make_rope_tables(cos[..., 0, :], sin[..., 0, :])
        block = _remat_wrap(
            lambda h, lp, w: self._block_fwd(h, lp, attn, rope,
                                             rope_tables=tables,
                                             window=w)[:2], remat)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for lp, w in zip(self._layers(params), self.attn_windows):
            h, a = block(h, lp, w)
            aux = aux + a
        h = self._norm_h(params, "lnf", h)
        return h, aux

    def apply_with_aux(self, params, tokens, positions, attn: str = "dense",
                       seq_axis: str = SEQ_AXIS, grad_reduce=None,
                       remat: str = "none"):
        """:meth:`apply` plus the summed auxiliary loss; ``seq_axis``,
        ``grad_reduce`` and ``remat`` as in :meth:`apply_hidden`."""
        h, aux = self.apply_hidden(params, tokens, positions, attn, seq_axis,
                                   grad_reduce=grad_reduce, remat=remat)
        return self._logits(params, h), aux

    def apply(self, params, tokens, positions, attn: str = "dense",
              seq_axis: str = SEQ_AXIS):
        """Teacher-forced logits ``[B, T, V]`` (float32) for ``tokens`` at
        absolute ``positions``, both int ``[B, T]``."""
        return self.apply_with_aux(params, tokens, positions, attn, seq_axis)[0]

    def loss(self, params, tokens, positions, targets, attn: str = "dense",
             seq_axis: str = SEQ_AXIS):
        """Summed next-token cross-entropy over the batch."""
        logits = self.apply(params, tokens, positions, attn, seq_axis)
        return _summed_xent(logits, _as_index(targets, logits.device))

    # -- generation ------------------------------------------------------------
    def prefill(self, params, tokens, cache, ffn_tag: str = "dense"):
        """Batched prompt ingestion: the full forward over ``tokens`` ``[B,
        T0]`` (flash attention: the kernel on the card, each layer within
        its window), writing every position's K/V into ``cache`` in place
        through :func:`write_prompt_cache` (a rolling cache shorter than
        the prompt keeps its last ``T`` positions). Returns ``(logits [B,
        T0, V], cache)``. ``ffn_tag`` is the reference's FFN route:
        ``"dense"`` is the single-device path; any other tag dispatches the
        MoE FFN over a sharded mesh axis, not ported yet."""
        if ffn_tag != "dense":
            raise NotImplementedError(
                f"prefill(ffn_tag={ffn_tag!r}) dispatches the MoE FFN over a "
                "sharded mesh axis, not ported yet (ROADMAP.md queue 1 item "
                "6, 'Speculation and sharding')")
        dev = params["tok"].device
        tokens = _as_index(tokens, dev)
        B, T0 = tokens.shape
        if T0 > cache["k"].shape[3] and not self._ring_cache:
            raise ValueError(f"prompt of {T0} tokens does not fit a cache of "
                             f"{cache['k'].shape[3]}")
        positions = torch.arange(T0, device=dev).expand(B, T0)
        h = self._embed(params, tokens, positions)
        rope = self._rope_for(positions)
        for l, lp in enumerate(self._layers(params)):
            h, _, k, v = self._block_fwd(h, lp, "flash", rope, ep_groups=1,
                                         window=self.attn_windows[l])
            write_prompt_cache(cache["k"][l], cache["v"][l], k.transpose(1, 2),
                               v.transpose(1, 2), self._ring_cache)
        h = self._norm_h(params, "lnf", h)
        return self._logits(params, h), cache

    def generate(self, params, prompt, n_new: int, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0):
        """Autoregressive continuation: ``prompt`` int ``[B, T0]`` → int32
        ``[B, T0 + n_new]`` on the params' device. One batched
        :meth:`prefill` over the prompt, then a loop of cached
        :meth:`decode_step` calls; the cache is sized to the horizon (a
        rolling cache to the window, for an all-windowed model), not
        ``max_len``.

        ``temperature=0`` (default) is greedy; ``> 0`` samples from
        ``softmax(logits / temperature)``, optionally restricted to the
        ``top_k`` most probable tokens and then to the ``top_p`` nucleus,
        deterministically per ``seed`` (see :func:`select_tokens`: draws
        keyed by ``(seed, row, position)``, other bits than the
        reference's ``jax.random``). No step syncs with the host."""
        dev = params["tok"].device
        prompt = _as_index(prompt, dev)
        B, T0 = prompt.shape
        total = T0 + int(n_new)
        if total > self.max_len:
            raise ValueError(
                f"prompt {T0} + n_new {n_new} exceeds max_len {self.max_len}")
        if top_k is not None and not 1 <= int(top_k) <= self.vocab:
            raise ValueError(
                f"top_k must be in [1, vocab={self.vocab}], got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if n_new < 1:
            return prompt.to(torch.int32)

        def select(logits, position):
            return select_tokens(logits, seed, position, temperature, top_k,
                                 top_p)

        with torch.no_grad():
            logits, cache = self.prefill(params, prompt,
                                         self.init_cache(B, total))
            buf = torch.empty((B, total), dtype=torch.int64, device=dev)
            buf[:, :T0] = prompt
            tok = select(logits[:, -1], T0)
            buf[:, T0] = tok
            for t in range(T0, total - 1):
                logits, cache = self.decode_step(params, tok, t, cache)
                tok = select(logits, t + 1)
                buf[:, t + 1] = tok
        return buf.to(torch.int32)

    # -- speculative decoding ----------------------------------------------------
    def generate_speculative(self, params, prompt, n_new: int,
                             draft: "TransformerLM", draft_params,
                             spec_k: int = 4, temperature: float = 0.0,
                             seed: int = 0, with_stats: bool = False,
                             host_loop: bool = False):
        """Speculative decoding (Leviathan/Chen et al.): a small ``draft``
        model proposes ``spec_k`` tokens a round with cached
        :meth:`decode_step` calls, and this model scores the carry and all
        proposals in ONE :meth:`decode_chunk` and accepts a prefix.
        ``prompt`` int ``[B, T0]`` → int32 ``[B, T0 + n_new]`` on the params'
        device (and, with ``with_stats``, ``{rounds, proposed, accepted,
        acceptance_rate, tokens_emitted}``; ``rounds`` counts the verify
        passes, against ``n_new`` sequential steps for :meth:`generate`).

        ``temperature=0`` accepts while this model's argmax agrees with the
        draft, and every correction is that argmax, so the output equals
        greedy :meth:`generate`, bit for bit where the chunk and the step
        share attention numerics (the CPU). On the card :meth:`decode_step`
        runs the flash-decode kernel and :meth:`decode_chunk` the plain
        masked softmax, so there the two agree up to near ties (the
        reference's own exactness caveat). ``temperature > 0`` applies the
        rejection rule (accept ``d`` w.p. ``min(1, p_t(d)/p_d(d))``,
        resample a rejection from ``(p_t − p_d)+``, the bonus from ``p_t``),
        which keeps this model's sampling distribution.

        Every round writes both caches from the first stale position on,
        over ``spec_k + 1`` positions, so a rejected round's stale K/V is
        rewritten before any query attends it. Each cache is sized to
        ``T0 + n_new + spec_k + 1``; chunk rows past ``max_len`` (a frozen
        row, a rejected tail near the horizon) read the last learned
        position row and are never emitted.

        ``host_loop=False`` (default) runs the rounds on device tensors:
        the draft's ``spec_k`` steps, one verify, the masked emission into
        a ``[B, total + spec_k + 1]`` buffer, the all-row draft ingest;
        the host reads ONE flag a round (whether a row is still short of
        ``total``) to stop. Sampled, it draws from a ``torch.Generator``
        seeded by ``seed`` (the distribution contract, with other bits
        than the reference's ``jax.random``). ``host_loop=True`` runs the
        reference's host loops: the bit-exact greedy oracle, and for
        sampling the float64 rejection math with ``numpy.random.
        default_rng(seed)`` (``[seed, row]`` per row when ``B > 1``), the
        generators the reference uses. ``B > 1`` rows carry their own
        positions; a finished row freezes at ``total - 1``."""
        if not self._supports_speculative:
            raise NotImplementedError(
                "speculative decoding needs chunk routing == per-position "
                "routing: for the MoE family that holds only when expert "
                "capacity never binds (capacity_factor * k >= n_experts; "
                "raise capacity_factor, or use the dense family)")
        if not draft._supports_speculative:
            raise NotImplementedError(
                "the draft model's routing must also be chunk-stable "
                "(dense, or MoE with capacity_factor * k >= n_experts)")
        dev = params["tok"].device
        prompt = _as_index(prompt, dev)
        B, T0 = prompt.shape
        if draft.vocab != self.vocab:
            raise ValueError(
                f"draft vocab {draft.vocab} != target vocab {self.vocab}")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        total = T0 + int(n_new)
        if total > self.max_len or total > draft.max_len:
            raise ValueError(
                f"prompt {T0} + n_new {n_new} exceeds max_len "
                f"(target {self.max_len}, draft {draft.max_len})")
        if n_new < 1:
            return prompt.to(torch.int32)
        args = (params, prompt, int(n_new), draft, draft_params, int(spec_k),
                float(temperature), int(seed))
        with torch.no_grad():
            if not host_loop:
                tokens, stats = self._generate_speculative_device(*args)
            elif B == 1:
                tokens, stats = self._generate_speculative_one(*args)
            else:
                tokens, stats = self._generate_speculative_batched(*args)
        if not with_stats:
            return tokens
        rounds, proposed, accepted = stats
        return tokens, {"rounds": rounds, "proposed": proposed,
                        "accepted": accepted,
                        "acceptance_rate": accepted / max(proposed, 1),
                        "tokens_emitted": int(B * n_new)}

    def _spec_prefills(self, params, prompt, draft, draft_params, horizon,
                       chunk):
        """Both prefills over ``prompt`` into caches of ``horizon`` →
        ``(target logits [B, T0, V], target cache, draft cache)``."""
        B = prompt.shape[0]
        t_logits, t_cache = self.prefill(
            params, prompt, self.init_cache(B, horizon, chunk=chunk))
        _, d_cache = draft.prefill(
            draft_params, prompt, draft.init_cache(B, horizon, chunk=chunk))
        return t_logits, t_cache, d_cache

    def _generate_speculative_one(self, params, prompt, n_new, draft,
                                  draft_params, spec_k, temperature, seed):
        """The reference's batch-1 host loop: proposals, acceptance and
        emission on the host; the draft ingests its last proposal only
        after a fully accepted round. → ``(tokens, (rounds, proposed,
        accepted))``."""
        dev = prompt.device
        T0 = prompt.shape[1]
        total = T0 + n_new
        t_logits, t_cache, d_cache = self._spec_prefills(
            params, prompt, draft, draft_params, total + spec_k + 1,
            spec_k + 1)
        rng = np.random.default_rng(seed)

        def choose(row):
            if temperature <= 0.0:
                return int(np.argmax(row))
            return int(rng.choice(self.vocab, p=_spec_probs(row, temperature)))

        def draft_step(tok, p, cache):
            dl, cache = draft.decode_step(
                draft_params, torch.tensor([tok], device=dev), p, cache)
            return dl[0].to(torch.float32).cpu().numpy(), cache

        out = prompt[0].tolist()
        carry = choose(t_logits[0, -1].to(torch.float32).cpu().numpy())
        out.append(carry)
        pos = T0        # absolute position of `carry`, in neither cache yet
        rounds = proposed = accepted = 0
        while len(out) < total:
            rounds += 1
            d_toks, d_probs = [], []
            tok, p = carry, pos
            for _ in range(spec_k):
                dl, d_cache = draft_step(tok, p, d_cache)
                if temperature > 0.0:
                    row = _spec_probs(dl, temperature)
                    tok = int(rng.choice(self.vocab, p=row))
                    d_probs.append(row)
                else:
                    tok = int(np.argmax(dl))
                d_toks.append(tok)
                p += 1
            chunk = torch.tensor([[carry] + d_toks], device=dev)
            vl, t_cache = self.decode_chunk(params, chunk, pos, t_cache)
            vl = vl[0].to(torch.float32).cpu().numpy()
            emitted, n = _spec_accept_row(vl, d_toks, d_probs, spec_k,
                                          self.vocab, temperature, rng)
            if n == spec_k:
                # the last proposal was never ingested by the draft: a hole
                # at pos + spec_k would corrupt every later proposal
                _, d_cache = draft_step(d_toks[-1], pos + spec_k, d_cache)
            proposed += spec_k
            accepted += n
            out.extend(emitted)
            pos += len(emitted)
            carry = emitted[-1]
        tokens = torch.tensor([out[:total]], dtype=torch.int32, device=dev)
        return tokens, (rounds, proposed, accepted)

    def _generate_speculative_batched(self, params, prompt, n_new, draft,
                                      draft_params, spec_k, temperature,
                                      seed):
        """The reference's batched (``B > 1``) host loop: per-row positions
        through both caches, per-row acceptance with the batch-1 rule and
        ``default_rng([seed, row])``; a finished row freezes (position
        clamped to ``total - 1``, later rounds rewrite its final span in
        place), and the last proposal is ingested for EVERY row each
        round (for a row that rejected, the write lands past its next
        round's start and is rewritten before anything attends it). →
        ``(tokens, (rounds, proposed, accepted))``."""
        dev = prompt.device
        B, T0 = prompt.shape
        total = T0 + n_new
        t_logits, t_cache, d_cache = self._spec_prefills(
            params, prompt, draft, draft_params, total + spec_k + 1,
            spec_k + 1)
        rngs = [np.random.default_rng([seed, b]) for b in range(B)]
        out = prompt.tolist()
        carry = np.empty((B,), np.int64)
        last = t_logits[:, -1].to(torch.float32).cpu().numpy()
        for b in range(B):
            carry[b] = (int(np.argmax(last[b])) if temperature <= 0.0
                        else int(rngs[b].choice(
                            self.vocab, p=_spec_probs(last[b], temperature))))
            out[b].append(int(carry[b]))
        pos = np.full((B,), T0, np.int64)
        rounds = proposed = accepted = 0
        while min(len(o) for o in out) < total:
            rounds += 1
            active = [len(o) < total for o in out]
            d_toks = np.empty((B, spec_k), np.int64)
            d_probs = [[None] * spec_k for _ in range(B)]
            tok, p = carry.copy(), pos.copy()
            for i in range(spec_k):
                dl, d_cache = draft.decode_step(
                    draft_params, torch.from_numpy(tok).to(dev),
                    torch.from_numpy(p).to(dev), d_cache)
                dlh = dl.to(torch.float32).cpu().numpy()
                for b in range(B):
                    if temperature > 0.0:
                        row = _spec_probs(dlh[b], temperature)
                        d_probs[b][i] = row
                        tok[b] = int(rngs[b].choice(self.vocab, p=row))
                    else:
                        tok[b] = int(np.argmax(dlh[b]))
                d_toks[:, i] = tok
                p += 1
            chunk = np.concatenate([carry[:, None], d_toks], 1)
            vl, t_cache = self.decode_chunk(
                params, torch.from_numpy(chunk).to(dev),
                torch.from_numpy(pos).to(dev), t_cache)
            vlh = vl.to(torch.float32).cpu().numpy()
            for b in range(B):
                emitted, n = _spec_accept_row(
                    vlh[b], d_toks[b], d_probs[b], spec_k, self.vocab,
                    temperature, rngs[b])
                if active[b]:
                    proposed += spec_k
                    accepted += n
                    out[b].extend(emitted)
                    pos[b] = min(pos[b] + len(emitted), total - 1)
                    carry[b] = emitted[-1]
            _, d_cache = draft.decode_step(
                draft_params, torch.from_numpy(d_toks[:, -1].copy()).to(dev),
                torch.from_numpy(p).to(dev), d_cache)
        tokens = torch.tensor([o[:total] for o in out], dtype=torch.int32,
                              device=dev)
        return tokens, (rounds, proposed, accepted)

    def _generate_speculative_device(self, params, prompt, n_new, draft,
                                     draft_params, spec_k, temperature,
                                     seed):
        """The round loop on device tensors (the reference's
        ``_spec_rollout_device``): greedy acceptance as a cumprod over the
        match mask, or the rejection rule in float32
        (:func:`spec_round_accept`) with draws from a ``torch.Generator``
        seeded by ``seed``; variable-length emission by masked writes into
        a per-row buffer; rows freeze as in the batched host loop. The
        host reads one flag a round. → ``(tokens, (rounds, proposed,
        accepted))``."""
        dev = prompt.device
        B, T0 = prompt.shape
        total = T0 + n_new
        t_logits, t_cache, d_cache = self._spec_prefills(
            params, prompt, draft, draft_params, total + spec_k + 1,
            spec_k + 1)
        sampled = temperature > 0.0
        gen = None
        if sampled:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)

        def draw(probs):
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        def probs_of(logits):
            return torch.softmax(logits.to(torch.float32) / temperature, dim=-1)

        last = t_logits[:, -1]
        carry = draw(probs_of(last)) if sampled else last.argmax(dim=-1)
        buf = torch.zeros((B, total + spec_k + 1), dtype=torch.int64, device=dev)
        buf[:, :T0] = prompt
        buf[:, T0] = carry
        pos = torch.full((B,), T0, dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)
        rounds = 0
        proposed = torch.zeros((), dtype=torch.int64, device=dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        while bool((pos + 1 < total).any()):        # the round's one host read
            rounds += 1
            active = pos + 1 < total
            tok, p = carry, pos
            d_toks, d_pd = [], []
            for _ in range(spec_k):
                dl, d_cache = draft.decode_step(draft_params, tok, p, d_cache)
                if sampled:
                    d_pd.append(probs_of(dl))
                    tok = draw(d_pd[-1])
                else:
                    tok = dl.argmax(dim=-1)
                d_toks.append(tok)
                p = p + 1
            d_toks = torch.stack(d_toks, dim=1)                       # [B, k]
            chunk = torch.cat([carry[:, None], d_toks], dim=1)
            vl, t_cache = self.decode_chunk(params, chunk, pos, t_cache)
            if sampled:
                u = torch.rand((B, spec_k), generator=gen, device=dev)
                n, resid = spec_round_accept(probs_of(vl), torch.stack(d_pd, 1),
                                             d_toks, u)
                corr = draw(resid)
            else:
                t_arg = vl.argmax(dim=-1)
                n = (t_arg[:, :spec_k] == d_toks).to(torch.int64).cumprod(1).sum(1)
                corr = t_arg.gather(1, n[:, None])[:, 0]
            for i in range(spec_k + 1):                 # masked emission
                val = torch.where(n > i, d_toks[:, i], corr) if i < spec_k else corr
                idx = (pos + 1 + i).clamp(max=total - 1)
                do = active & (n >= i) & (pos + 1 + i < total)
                buf[rows, idx] = torch.where(do, val, buf[rows, idx])
            # ingest the last proposal into the draft cache for ALL rows
            _, d_cache = draft.decode_step(draft_params, d_toks[:, -1], p, d_cache)
            pos = torch.where(active, (pos + n + 1).clamp(max=total - 1), pos)
            carry = torch.where(active, corr, carry)
            proposed += spec_k * active.sum()
            accepted += torch.where(active, n, 0).sum()
        return (buf[:, :total].to(torch.int32),
                (rounds, int(proposed), int(accepted)))


class MoETransformerLM(TransformerLM):
    """Mixture-of-experts LM: every block's FFN is a top-``k`` routed
    expert layer (:class:`~elephas_tpu_torch.parallel.MoEFeedForward`), the
    reference's ``MoETransformerLM`` on one device. Total parameters scale
    with ``n_experts`` while per-token FLOPs stay constant; the Switch
    load-balancing aux, weighted by ``aux_weight``, enters the training
    objective.

    ``activation``/``ffn_bias`` configure the experts, the other knobs the
    attention and norm stack (together the Mixtral shape: swiglu experts
    without biases, rmsnorm, rotary, GQA). ``param_dtype="bfloat16"``
    stores the expert stacks in bf16 (the router and everything else stay
    float32). ``moe_dispatch`` picks the single-device executor, all with
    the same routing decisions: ``"gmm"`` (the grouped-matmul kernels),
    ``"slots"`` (capacity slots, the default), ``"ragged"`` (sort + one
    matmul per expert) or ``"onehot"`` (the GShard oracle). ``ep_groups``
    splits each sequence into that many dispatch groups on the
    teacher-forced ``attn="dense"`` path, as the reference's dense path
    emulates its expert-sharded groups; ``attn="flash"`` routes the whole
    ``B·T`` block as one group, and decode, chunks and prefill always use
    one group. Expert parallelism is not ported yet."""

    @property
    def _supports_speculative(self):
        # chunked verification routes a chunk as ONE dispatch group while a
        # rollout routes per position: they agree iff capacity never binds,
        # cap(n) = ceil(cf·k·n/E) >= n for every n, i.e. cf·k >= E
        return self.moe.capacity_factor * self.moe.k >= self.moe.n_experts

    def __init__(self, vocab: int, d_model: int, n_heads: int, n_layers: int,
                 d_ff: int, max_len: int, n_experts: int, k: int = 2,
                 capacity_factor: float = 1.25, aux_weight: float = 1e-2,
                 ep_groups: int = 1, compute_dtype: str = "float32",
                 routing: str = "token_choice", pos_encoding: str = "learned",
                 tie_embeddings: bool = False,
                 n_kv_heads: Optional[int] = None, activation: str = "relu",
                 norm: str = "layernorm", norm_eps: float = 1e-5,
                 attn_bias: bool = False, ffn_bias: bool = True,
                 rope_theta: float = 10000.0,
                 attn_window: Optional[int] = None,
                 moe_dispatch: str = "slots", param_dtype: str = "float32",
                 device: DeviceLike = "cuda"):
        super().__init__(vocab, d_model, n_heads, n_layers, d_ff, max_len,
                         compute_dtype=compute_dtype,
                         pos_encoding=pos_encoding,
                         tie_embeddings=tie_embeddings,
                         n_kv_heads=n_kv_heads, activation=activation,
                         norm=norm, norm_eps=norm_eps, attn_bias=attn_bias,
                         ffn_bias=ffn_bias, rope_theta=rope_theta,
                         attn_window=attn_window, device=device)
        from ..parallel.expert import MoEFeedForward

        if routing == "expert_choice":
            # experts pick their top-C tokens across the whole block, so a
            # token's routing would depend on FUTURE tokens
            raise ValueError(
                "routing='expert_choice' breaks causality in a decoder LM "
                "(routing would depend on future tokens); use "
                "'token_choice' here, or MoEFeedForward directly for "
                "non-causal workloads")
        self.moe = MoEFeedForward(d_model, d_ff, n_experts, k=k,
                                  capacity_factor=capacity_factor,
                                  routing=routing, activation=activation,
                                  bias=ffn_bias, param_dtype=param_dtype)
        if moe_dispatch not in ("slots", "gmm", "ragged", "onehot"):
            raise ValueError(f"Unknown moe_dispatch: {moe_dispatch!r}")
        self.n_experts = n_experts
        self.aux_weight = aux_weight
        self.ep_groups = int(ep_groups)
        self.moe_dispatch = moe_dispatch

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The dense model's shapes with the FFN stacks replaced by the
        per-layer expert stacks ``[L, ...]``, in the reference's order."""
        shapes = super().param_shapes()
        for k_ in ("w1", "b1", "w2", "b2", "w3"):
            shapes.pop(k_, None)
        for k_, shape in self.moe.param_shapes().items():
            shapes[k_] = (self.n_layers,) + shape
        return shapes

    def init(self, seed: int = 0,
             device: Optional[DeviceLike] = None) -> Dict[str, torch.Tensor]:
        """:meth:`TransformerLM.init`'s draws, with the expert stacks then
        stored in ``param_dtype`` (bitwise the reference's values: both
        round the same float32 draws to bf16)."""
        params = super().init(seed, device)
        for k_ in self.moe.expert_keys():
            params[k_] = params[k_].to(self.moe.param_dtype)
        return params

    def _block_keys(self):
        base = [k for k in super()._block_keys()
                if k not in ("w1", "b1", "w2", "b2", "w3")]
        return tuple(base) + ("wg",) + self.moe.expert_keys()

    def _ffn(self, lp, x, attn: str = "dense", ep_groups: Optional[int] = None):
        """Routed experts on ``x`` ``[B, T, D]`` → ``(y [B, T, D] float32,
        aux)``. Under ``attn != "dense"`` the whole ``B·T`` block is one
        dispatch group. The dense path splits each sequence into ``G =
        ep_groups`` (default ``self.ep_groups``) chunks and flattens each
        chunk batch-major, the token groups an expert-sharded run would
        dispatch, before the executor's contiguous per-group split."""
        B, T, D = x.shape
        moe_params = {k_: lp[k_] for k_ in ("wg",) + self.moe.expert_keys()}
        execute = {"slots": self.moe.apply_slots, "gmm": self.moe.apply_gmm,
                   "ragged": self.moe.apply_grouped,
                   "onehot": self.moe.apply_reference}[self.moe_dispatch]
        if attn != "dense":
            y, aux = execute(moe_params, x.reshape(B * T, D))
            return y.reshape(B, T, D), aux
        G_ = self.ep_groups if ep_groups is None else ep_groups
        if T % G_:
            raise ValueError(f"T={T} not divisible by ep_groups={G_}")
        tl = T // G_
        xg = x.reshape(B, G_, tl, D).transpose(0, 1).reshape(G_ * B * tl, D)
        y, aux = execute(moe_params, xg, ep=G_)
        y = y.reshape(G_, B, tl, D).transpose(0, 1).reshape(B, T, D)
        return y, aux


# -- training ------------------------------------------------------------------


def _as_index(x, device):
    """An int array or tensor as an int64 tensor on ``device``."""
    return torch.as_tensor(x, device=device).to(torch.int64)


def make_lm_batches(token_rows: np.ndarray):
    """Host-side prep: ``[B, T+1]`` int rows → ``(tokens, positions,
    targets)`` each int32 ``[B, T]``, targets pre-shifted."""
    tokens = token_rows[:, :-1]
    targets = token_rows[:, 1:]
    positions = np.broadcast_to(
        np.arange(tokens.shape[1], dtype=np.int32), tokens.shape)
    return tokens.astype(np.int32), positions.copy(), targets.astype(np.int32)


def _validate_lm_step(model: TransformerLM, mesh, attn: str) -> None:
    """Build-time validation shared by the train and eval builders."""
    if attn not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError(f"Unknown attn: {attn}")
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (data or sequence parallelism) is not ported yet; "
            "pass mesh=None for one device (ROADMAP.md queue 1, "
            "'Speculation and sharding' and 'Parallel extensions')")
    if attn in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn={attn!r} needs sequence parallelism, not ported yet; use "
            "'flash' or 'dense' (ROADMAP.md queue 1, 'Parallel extensions')")


def _check_seq_len(model: TransformerLM, t: int) -> None:
    """Call-time guard shared by the train and eval steps: a position past
    ``max_len`` has no learned embedding."""
    if t > model.max_len:
        raise ValueError(f"sequence length {t} exceeds max_len {model.max_len}")


def _lm_step_parts(model: TransformerLM, mesh, optimizer, attn: str,
                   accum_steps: int, vocab_block: Optional[int], overlap_grads,
                   fused_apply: bool, remat: str):
    """The pieces :func:`build_lm_train_step` and
    :func:`build_lm_train_phases` share, after their validation: ``(loss,
    grad, apply)``, the forward objective, the forward and backward, and
    the optimizer phase."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if overlap_grads not in (False, True, "ring"):
        raise ValueError(f"overlap_grads must be False, True, or 'ring', "
                         f"got {overlap_grads!r}")
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"Unknown remat policy: {remat!r} (none|dots|full)")
    if fused_apply and not hasattr(optimizer, "fused_apply"):
        raise ValueError(
            "fused_apply=True needs an optimizer exposing fused_apply(grads, "
            "opt_state, params); use adam_compact / fused_adam from "
            "models/optimizers.py")
    _validate_lm_step(model, mesh, attn)
    if overlap_grads:
        raise NotImplementedError(
            "overlap_grads buckets the gradient all-reduce across devices, "
            "not ported yet (ROADMAP.md queue 1 item 6, 'Speculation and "
            "sharding')")

    def objective(params, tokens, positions, targets, ntok):
        # the micro-batches' objectives SUM to the full batch's: the
        # cross-entropy is normalised by the batch's token count, the aux
        # term (a per-call mean) by accum_steps
        if vocab_block is None:
            logits, aux = model.apply_with_aux(params, tokens, positions, attn,
                                               remat=remat)
            ce = _summed_xent(logits, targets)
        else:
            h, aux = model.apply_hidden(params, tokens, positions, attn,
                                        remat=remat)
            ce = chunked_summed_xent(h, model.head_weight(params), targets,
                                     vocab_block)
        return ce / ntok + (model.aux_weight / accum_steps) * aux

    def micro_batches(params, tokens, positions, targets):
        """The batch as index tensors on the params' device, cut into
        ``accum_steps`` row slices → ``(batch, row slices, token count)``."""
        dev = params["tok"].device
        batch = tuple(_as_index(a, dev) for a in (tokens, positions, targets))
        _check_seq_len(model, batch[0].shape[1])
        B = batch[0].shape[0]
        if B % accum_steps:
            raise ValueError(f"local batch {B} not divisible by accum_steps "
                             f"{accum_steps}")
        micro = B // accum_steps
        rows = [slice(i * micro, (i + 1) * micro) for i in range(accum_steps)]
        return batch, rows, float(batch[0].numel())

    def loss(params, tokens, positions, targets):
        batch, rows, ntok = micro_batches(params, tokens, positions, targets)
        total = None
        with torch.no_grad():
            for r in rows:
                obj = objective(params, *(a[r] for a in batch), ntok)
                total = obj if total is None else total + obj
        return total

    def grad(params, tokens, positions, targets):
        batch, rows, ntok = micro_batches(params, tokens, positions, targets)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total, grads = None, None
        for r in rows:
            obj = objective(leaves, *(a[r] for a in batch), ntok)
            g = torch.autograd.grad(obj, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
            obj = obj.detach()
            total = obj if total is None else total + obj
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        return total, dict(zip(leaves, grads))

    def apply(params, opt_state, grads):
        if fused_apply:
            return optimizer.fused_apply(grads, opt_state, params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads       # the step's gradients die here, before the new params
        return ({k: (p + updates.pop(k)).to(p.dtype) for k, p in params.items()},
                opt_state)

    return loss, grad, apply


def build_lm_train_step(model: TransformerLM, mesh, optimizer,
                        attn: str = "ring", accum_steps: int = 1,
                        vocab_block: Optional[int] = None,
                        overlap_grads=False, fused_apply: bool = False,
                        remat: str = "none"):
    """One LM training step on one device.

    Returns ``(step, opt_init)``: ``step(params, opt_state, tokens,
    positions, targets) -> (params, opt_state, loss)`` with the three int
    arrays ``[B, T]`` (numpy or tensors) and ``loss`` the objective (the
    token-mean cross-entropy plus ``model.aux_weight`` times the summed aux
    loss, 0 for a dense FFN) as a 0-d tensor on the device (no host sync per
    step);
    ``opt_init(params) -> opt_state``. The step returns new params and
    state and leaves its arguments untouched. ``step.grad(params, tokens,
    positions, targets) -> (loss, grads)`` is the forward and backward
    alone.

    The signature is the reference's. ``mesh`` must be ``None`` (one
    device); a mesh, ``attn="ring"``/``"ulysses"`` (the default, kept from
    the reference) and ``overlap_grads`` raise ``NotImplementedError``.
    ``attn="flash"`` runs the flash-attention kernels forward and backward
    on the card. ``vocab_block`` streams the loss head in that many vocab
    columns (:func:`chunked_summed_xent`). ``accum_steps > 1`` splits the
    batch into that many micro-batches whose gradients are summed before
    one optimizer step. ``fused_apply`` uses ``optimizer.fused_apply``
    (bit-identical to ``update`` + apply). ``remat`` is the per-layer
    rematerialisation policy (``"none"|"dots"|"full"``)."""
    _, grad, apply = _lm_step_parts(model, mesh, optimizer, attn, accum_steps,
                                    vocab_block, overlap_grads, fused_apply,
                                    remat)

    def step(params, opt_state, tokens, positions, targets):
        loss, grads = grad(params, tokens, positions, targets)
        # the list hands the gradients over: with no name of the step's
        # still bound to them, apply's own ``del`` frees them before the
        # new params are built, so the two never share the peak
        held = [grads]
        del grads
        params, opt_state = apply(params, opt_state, held.pop())
        return params, opt_state, loss

    step.grad = grad
    return step, optimizer.init


def build_lm_train_phases(model: TransformerLM, mesh, optimizer,
                          attn: str = "ring", accum_steps: int = 1,
                          vocab_block: Optional[int] = None,
                          overlap_grads=False, fused_apply: bool = False,
                          remat: str = "none"):
    """Per-phase probes of :func:`build_lm_train_step`'s stages, so a
    measured gain can be attributed (forward, backward, optimizer). The
    same validation and the same pieces as the step; returns the
    reference's dict:

    - ``"loss"(params, tokens, positions, targets) -> loss``: the forward
      objective alone (no autograd graph);
    - ``"grad"(params, tokens, positions, targets) -> (loss, grads)``: the
      forward and backward, the step's ``step.grad``, so ``grad − loss``
      times the backward;
    - ``"reduce"(grads) -> grads``: the post-backward gradient reduction,
      the identity on one device;
    - ``"apply"(params, opt_state, grads) -> (params, opt_state)``: the
      optimizer phase, fused or not. It leaves its arguments untouched
      (nothing is donated), so a probe can run again on the same tensors,
      and ``apply(params, opt_state, grad(...)[1])`` is the step."""
    loss, grad, apply = _lm_step_parts(model, mesh, optimizer, attn,
                                       accum_steps, vocab_block, overlap_grads,
                                       fused_apply, remat)
    return {"loss": loss, "grad": grad, "reduce": lambda grads: grads,
            "apply": apply}


def build_lm_eval_step(model: TransformerLM, mesh, attn: str = "ring"):
    """``eval_fn(params, tokens, positions, targets) -> mean next-token
    cross-entropy`` (a 0-d tensor; perplexity is its ``exp``) on one
    device, under the train step's validation rules."""
    _validate_lm_step(model, mesh, attn)

    def eval_fn(params, tokens, positions, targets):
        tokens = _as_index(tokens, params["tok"].device)
        _check_seq_len(model, tokens.shape[1])
        with torch.no_grad():
            return model.loss(params, tokens, positions, targets,
                              attn=attn) / tokens.numel()

    return eval_fn


def __getattr__(name):
    # MultiTenantLM subclasses TransformerLM in lora.py, which imports this
    # module; the re-export resolves on first use
    if name == "MultiTenantLM":
        from .lora import MultiTenantLM
        return MultiTenantLM
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
