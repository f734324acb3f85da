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
  and backward), the losses (:func:`chunked_summed_xent` streams the head),
  per-layer rematerialisation, and :func:`build_lm_train_step` /
  :func:`build_lm_eval_step` on one device.
- Generation: :meth:`~TransformerLM.prefill` (the full forward over the
  prompt, flash attention) and :meth:`~TransformerLM.generate` (one prefill,
  then a loop of cached decode steps; greedy, temperature, top-k, top-p).

Every LayerNorm goes through the fused kernels on the card, backward
included. Architecture knobs ported: relu / gelu (tanh) / swiglu, layernorm
/ rmsnorm, attention and FFN biases, learned / rotary positions, tied
embeddings, grouped-query attention, float32 or bfloat16 compute. Sliding
windows with rolling caches, MoE, LoRA, sequence parallelism (``mesh``,
``attn="ring"``/``"ulysses"``) and ``overlap_grads`` are later slices and
raise ``NotImplementedError``.

JAX's arrays are immutable and its serving kernels donate the KV cache so
XLA updates it in place; here the cache is updated in place explicitly
(slice assignment or ``scatter_``), and the methods return the same dict
they were given. The train step returns new parameter and optimizer-state
dicts and leaves its arguments untouched.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import DeviceLike, resolve_device
from ..ops.flash_attention import attention_reference, flash_attention
from ..ops.flash_decode import aligned_cache_length, decode_attention
from ..ops.layer_norm import layer_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    # cache[b, h, pos_b + s, d] = new[b, h, s, d] as one scatter along T
    rows = torch.as_tensor(pos, device=cache.device).to(torch.int64)
    idx = rows.reshape(-1, 1, 1, 1)
    if S > 1:
        idx = idx + torch.arange(S, device=cache.device).reshape(1, 1, S, 1)
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
        if attn_window is not None:
            raise NotImplementedError(
                "sliding-window attention and rolling caches are not ported "
                "yet (ROADMAP.md queue 1, 'LM remainder')")
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
        """Token (+ learned-position) embedding in the compute dtype."""
        h = params["tok"][tokens]
        if self.pos_encoding == "learned":
            h = h + params["pos"][positions]
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

    def _ffn(self, lp, x):
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
        return out

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

    # -- autoregressive inference (KV cache) ---------------------------------
    def init_cache(self, batch: int,
                   length: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Zeroed KV cache ``{"k"/"v": [L, B, Hkv, T, Dh]}`` on the model's
        device, ``T`` = ``length`` (default ``max_len``) rounded up as the
        reference rounds it, so both packages allocate the same shapes."""
        T = aligned_cache_length(self.max_len if length is None else length)
        shape = (self.n_layers, batch, self.n_kv_heads, T,
                 self.d_model // self.n_heads)
        return {"k": torch.zeros(shape, dtype=self.compute_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.compute_dtype, device=self.device)}

    def decode_step(self, params, token, pos, cache):
        """One cached decode step: ``token`` ``[B]`` at absolute position
        ``pos`` (int, or per-row ``[B]`` tensor) → ``(logits [B, V],
        cache)``. Writes each layer's K/V at ``pos`` in place, then attends
        over cache positions ``0..pos`` with the flash-decode kernel (its
        plain version on the CPU)."""
        B = token.shape[0]
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        cd = self.compute_dtype
        pos_b, per_row = _positions(pos, B, token.device)
        pos32 = pos_b.to(torch.int32)   # the kernel's index type, cast once
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
            _cache_update_rows(kc, k_new, pos, per_row)
            _cache_update_rows(vc, v_new, pos, per_row)
            # grouped attention straight against the Hkv-head cache: query
            # head h = kv_head * G + g
            qg = q.reshape(B, Hkv, H // Hkv, Dh)
            a = decode_attention(qg, kc, vc, pos32).to(cd)
            h = h + self._attn_proj(lp, "o", a.reshape(B, self.d_model))
            x = self._norm_h(lp, "ln2", h).to(cd)
            h = h + self._ffn(lp, x).to(cd)
        h = self._norm_h(params, "lnf", h)
        return self._logits(params, h), cache

    def decode_chunk(self, params, tokens, pos0, cache):
        """Cached forward over a block of ``S`` tokens at absolute
        positions ``pos0..pos0+S-1`` (``pos0`` an int or per-row ``[B]``
        tensor) → ``(logits [B, S, V], cache)``. Writes the chunk's K/V in
        place first, then attends each query against cache positions
        ``0..its own position`` — so a chunk starting at the first stale
        position also repairs it. The attention is a plain masked softmax
        over the whole cache, as in the reference."""
        B, S = tokens.shape
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        G = H // Hkv
        cd = self.compute_dtype
        T = cache["k"].shape[3]
        dev = tokens.device
        base, per_row = _positions(pos0, B, dev)
        pos_b = base[:, None] + torch.arange(S, device=dev)[None, :]   # [B, S]
        h = self._embed(params, tokens, pos_b)  # [B, S, D]
        rope = self._rope_for(pos_b)
        slots = torch.arange(T, device=dev)[None, None, :]
        visible = (slots <= pos_b[:, :, None])[:, None, None]   # [B,1,1,S,T]
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
            _cache_update_rows(kc, k_new.transpose(1, 2), pos0, per_row)
            _cache_update_rows(vc, v_new.transpose(1, 2), pos0, per_row)
            qg = q.transpose(1, 2).reshape(B, Hkv, G, S, Dh)
            scores = torch.einsum("bkgsd,bktd->bkgst", qg.to(torch.float32),
                                  kc.to(torch.float32)) * (Dh ** -0.5)
            probs = torch.softmax(scores.masked_fill(~visible, float("-inf")),
                                  dim=-1)
            a = torch.einsum("bkgst,bktd->bkgsd", probs,
                             vc.to(torch.float32)).to(cd)
            a = a.reshape(B, H, S, Dh).transpose(1, 2)
            h = h + self._attn_proj(lp, "o", a.reshape(B, S, self.d_model))
            x = self._norm_h(lp, "ln2", h).to(cd)
            h = h + self._ffn(lp, x).to(cd)
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
        logits must not be sampled from."""
        slot_cache = cache_gather_slot(cache, slot)
        logits, slot_cache = self.decode_chunk(params, tokens, pos0, slot_cache)
        return logits, cache_scatter_slot(cache, slot, slot_cache)

    # -- teacher-forced forward (training) ------------------------------------
    def _layers(self, params):
        """Per-layer views of the stacked ``[L, ...]`` params (``unbind``,
        whose backward stacks the layer gradients in one copy)."""
        keys = self._block_keys()
        return [dict(zip(keys, vals))
                for vals in zip(*(params[k].unbind(0) for k in keys))]

    def _attend(self, q, k, v, attn: str):
        """Causal attention over a full sequence: ``"dense"`` is the plain
        oracle (autograd through PyTorch ops), ``"flash"`` the
        flash-attention kernels on the card (their plain versions on the
        CPU). KV heads are never repeated on the flash path."""
        if attn == "dense":
            return attention_reference(q, k, v, causal=True)
        if attn == "flash":
            return flash_attention(q, k, v, causal=True)
        if attn in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn={attn!r} needs sequence parallelism, not ported yet "
                "(ROADMAP.md queue 1, 'Parallel extensions')")
        raise ValueError(f"Unknown attn: {attn}")

    def _block_fwd(self, h, lp, attn: str, rope=None):
        """One transformer block on ``h`` ``[B, T, D]``, the block math
        shared by the teacher-forced forward and :meth:`prefill`. Layernorm
        runs in float32, everything else in the compute dtype; under rotary
        positions q and k rotate by ``rope`` before attention (so the
        returned, cacheable k is pre-rotated). Returns ``(h, k, v)`` with
        ``k``/``v`` ``[B, T, Hkv, Dh]``."""
        B, T = h.shape[0], h.shape[1]
        H, Hkv = self.n_heads, self.n_kv_heads
        Dh = self.d_model // H
        cd = self.compute_dtype
        x = self._norm_h(lp, "ln1", h).to(cd)
        q = self._attn_proj(lp, "q", x).reshape(B, T, H, Dh)
        k = self._attn_proj(lp, "k", x).reshape(B, T, Hkv, Dh)
        v = self._attn_proj(lp, "v", x).reshape(B, T, Hkv, Dh)
        if rope is not None:
            q = _rope_rotate(q, *rope)
            k = _rope_rotate(k, *rope)
        a = self._attend(q, k, v, attn).to(cd)
        h = h + self._attn_proj(lp, "o", a.reshape(B, T, self.d_model))
        x = self._norm_h(lp, "ln2", h).to(cd)
        return h + self._ffn(lp, x).to(cd), k, v

    def apply_hidden(self, params, tokens, positions, attn: str = "dense",
                     remat: str = "none"):
        """The forward up to and including the final norm: ``tokens`` and
        ``positions`` (absolute) int ``[B, T]`` → ``(h [B, T, D], aux)``,
        ``aux`` the summed auxiliary loss (0 for this dense model). Lets a
        large-vocab loss stream the head (:func:`chunked_summed_xent`).
        ``remat`` is the per-layer rematerialisation policy
        (``"none"|"dots"|"full"``)."""
        dev = params["tok"].device
        tokens, positions = _as_index(tokens, dev), _as_index(positions, dev)
        h = self._embed(params, tokens, positions)
        rope = self._rope_for(positions)
        block = _remat_wrap(lambda h, lp: self._block_fwd(h, lp, attn, rope)[0],
                            remat)
        for lp in self._layers(params):
            h = block(h, lp)
        h = self._norm_h(params, "lnf", h)
        return h, torch.zeros((), dtype=torch.float32, device=dev)

    def apply_with_aux(self, params, tokens, positions, attn: str = "dense",
                       remat: str = "none"):
        """:meth:`apply` plus the summed auxiliary loss (0 here)."""
        h, aux = self.apply_hidden(params, tokens, positions, attn, remat)
        return self._logits(params, h), aux

    def apply(self, params, tokens, positions, attn: str = "dense"):
        """Teacher-forced logits ``[B, T, V]`` (float32) for ``tokens`` at
        absolute ``positions``, both int ``[B, T]``."""
        return self.apply_with_aux(params, tokens, positions, attn)[0]

    def loss(self, params, tokens, positions, targets, attn: str = "dense"):
        """Summed next-token cross-entropy over the batch."""
        logits = self.apply(params, tokens, positions, attn)
        return _summed_xent(logits, _as_index(targets, logits.device))

    # -- generation ------------------------------------------------------------
    def prefill(self, params, tokens, cache):
        """Batched prompt ingestion: the full forward over ``tokens`` ``[B,
        T0]`` (flash attention: the kernel on the card), writing every
        position's K/V into ``cache`` at offset 0 in place. Returns
        ``(logits [B, T0, V], cache)``."""
        dev = params["tok"].device
        tokens = _as_index(tokens, dev)
        B, T0 = tokens.shape
        if T0 > cache["k"].shape[3]:
            raise ValueError(f"prompt of {T0} tokens does not fit a cache of "
                             f"{cache['k'].shape[3]}")
        positions = torch.arange(T0, device=dev).expand(B, T0)
        h = self._embed(params, tokens, positions)
        rope = self._rope_for(positions)
        for l, lp in enumerate(self._layers(params)):
            h, k, v = self._block_fwd(h, lp, "flash", rope)
            cache["k"][l, :, :, :T0] = k.transpose(1, 2)
            cache["v"][l, :, :, :T0] = v.transpose(1, 2)
        h = self._norm_h(params, "lnf", h)
        return self._logits(params, h), cache

    def generate(self, params, prompt, n_new: int, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0):
        """Autoregressive continuation: ``prompt`` int ``[B, T0]`` → int32
        ``[B, T0 + n_new]`` on the params' device. One batched
        :meth:`prefill` over the prompt, then a loop of cached
        :meth:`decode_step` calls; the cache is sized to the horizon, not
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


class MoETransformerLM:
    """The reference's mixture-of-experts LM (``MoETransformerLM`` in
    ``elephas_tpu/models/transformer.py``); not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MoE needs the grouped-matmul kernel K6, not ported yet "
            "(ROADMAP.md queue 1, 'MoE (K6)')")


class MultiTenantLM:
    """The reference's multi-tenant LoRA LM (``MultiTenantLM`` in
    ``elephas_tpu/models/lora.py``); not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "multi-tenant LoRA serving rides the paged engine, not ported yet "
            "(ROADMAP.md queue 1, 'Paged serving (K5)')")


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


def build_lm_train_step(model: TransformerLM, mesh, optimizer,
                        attn: str = "ring", accum_steps: int = 1,
                        vocab_block: Optional[int] = None,
                        overlap_grads=False, fused_apply: bool = False,
                        remat: str = "none"):
    """One LM training step on one device.

    Returns ``(step, opt_init)``: ``step(params, opt_state, tokens,
    positions, targets) -> (params, opt_state, loss)`` with the three int
    arrays ``[B, T]`` (numpy or tensors) and ``loss`` the token-mean
    cross-entropy as a 0-d tensor on the device (no host sync per step);
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
            "not ported yet (ROADMAP.md queue 1, 'LM remainder')")

    def objective(params, tokens, positions, targets, ntok):
        if vocab_block is None:
            logits, _ = model.apply_with_aux(params, tokens, positions, attn,
                                             remat)
            ce = _summed_xent(logits, targets)
        else:
            h, _ = model.apply_hidden(params, tokens, positions, attn, remat)
            ce = chunked_summed_xent(h, model.head_weight(params), targets,
                                     vocab_block)
        return ce / ntok

    def grad(params, tokens, positions, targets):
        dev = params["tok"].device
        tokens, positions, targets = (_as_index(a, dev)
                                      for a in (tokens, positions, targets))
        _check_seq_len(model, tokens.shape[1])
        B = tokens.shape[0]
        if B % accum_steps:
            raise ValueError(f"local batch {B} not divisible by accum_steps "
                             f"{accum_steps}")
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        ntok = float(tokens.numel())
        micro = B // accum_steps
        loss, grads = None, None
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            obj = objective(leaves, tokens[rows], positions[rows],
                            targets[rows], ntok)
            g = torch.autograd.grad(obj, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
            obj = obj.detach()
            loss = obj if loss is None else loss + obj
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        return loss, dict(zip(leaves, grads))

    def step(params, opt_state, tokens, positions, targets):
        loss, grads = grad(params, tokens, positions, targets)
        if fused_apply:
            params, opt_state = optimizer.fused_apply(grads, opt_state, params)
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
        return params, opt_state, loss

    step.grad = grad
    return step, optimizer.init


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
