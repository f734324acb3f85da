"""LoRA fine-tuning and multi-tenant adapters for the LM family (port of
``elephas_tpu/models/lora.py``).

Low-Rank Adaptation (Hu et al. 2021): freeze the pretrained weights, learn
a rank-``r`` update ``ΔW = (α/r)·A·B`` per adapted matrix. The adapted
entries of the params dict become :class:`LoRATensor` nodes, which
materialize ``W.detach() + (α/r)·A·B`` where the LM reads a weight, so
gradients reach only the adapter factors. The model code is unchanged: the
node answers the handful of operations the LM applies to its weights (a
layer's index or ``unbind``, ``.to(dtype)``, ``@``, ``.T``), and indexing
along the leading (layer) axes stays lazy, so a layer loop materializes one
layer at a time, never the whole stack.

``B`` starts at zero, so the adapted model starts exactly at the base
model; :func:`merge_lora` bakes the learned update into plain tensors.

:class:`MultiTenantLM` carries ``n_adapters`` stacked adapters for
multi-tenant serving: one base model, many fine-tuned variants, selected
per batch row by :meth:`~MultiTenantLM.adapter_context`, which the paged
serving cache enters around every launch. The per-row deltas are two thin
products outside any attention kernel, as in the reference.

:func:`build_lora_lm_train_step` trains the factors of a LoRA-adapted
params dict on one device: the gradient is taken with respect to the
factors alone, and the optimizer, wrapped in
:func:`~elephas_tpu_torch.models.optimizers.masked` over :func:`lora_mask`,
keeps state for the factors only.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .optimizers import masked
from .transformer import (_DTYPES, TransformerLM, _as_index, _check_seq_len,
                          _summed_xent, _validate_lm_step, chunked_summed_xent)


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


class LoRATensor:
    """Frozen base ``w`` ``[*, in, out]`` + trainable ``a`` ``[*, in, r]``,
    ``b`` ``[*, r, out]``; materializes ``w + (α/r)·a@b`` lazily, in
    float32, then casts. Leading axes broadcast: an integer or slice index,
    ``unbind(0)`` and a leading-dim ``reshape`` return nodes, so a layer
    stack survives the LM's per-layer loop without materializing."""

    _fields = ("w", "a", "b")

    def __init__(self, w, a, b, alpha: float):
        self.w = w
        self.a = a
        self.b = b
        self.alpha = alpha

    def tree_flatten(self):
        return (self.w, self.a, self.b), self.alpha

    @classmethod
    def tree_unflatten(cls, alpha, children):
        return cls(*children, alpha)

    def __repr__(self) -> str:
        return (f"LoRATensor(shape={tuple(self.w.shape)}, "
                f"rank={self.a.shape[-1]}, alpha={self.alpha})")

    @property
    def shape(self):
        return self.w.shape

    @property
    def ndim(self) -> int:
        return len(self.w.shape)

    @property
    def device(self):
        return self.w.device

    def materialize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        rank = self.a.shape[-1]
        delta = torch.matmul(self.a.to(torch.float32),
                             self.b.to(torch.float32)) * (self.alpha / rank)
        return (self.w.detach().to(torch.float32) + delta).to(dtype)

    def astype(self, dtype: torch.dtype) -> torch.Tensor:
        return self.materialize(dtype)

    def _map(self, fn) -> "LoRATensor":
        return LoRATensor(fn(self.w), fn(self.a), fn(self.b), self.alpha)

    # -- the operations the LM applies to its weights --------------------
    def to(self, *args, **kwargs):
        """``.to(device)`` moves the three parts (a node); ``.to(dtype)``
        materializes in that dtype."""
        dtype, device = kwargs.pop("dtype", None), kwargs.pop("device", None)
        if kwargs:
            raise TypeError(f"LoRATensor.to takes a device and a dtype, got "
                            f"{sorted(kwargs)}")
        for arg in args:
            if isinstance(arg, torch.dtype):
                dtype = arg
            else:
                device = arg
        node = self if device is None else self._map(lambda t: t.to(device))
        return node if dtype is None else node.materialize(dtype)

    @property
    def T(self):
        return self.materialize().T

    def __rmatmul__(self, other):
        w = self.materialize(torch.promote_types(other.dtype, torch.float32))
        return other.to(w.dtype) @ w

    def __getitem__(self, idx):
        if self.ndim > 2 and isinstance(idx, (int, np.integer, slice)):
            return self._map(lambda t: t[idx])
        return self.materialize()[idx]

    def unbind(self, dim: int = 0):
        if dim != 0 or self.ndim <= 2:
            return self.materialize().unbind(dim)
        return [LoRATensor(w, a, b, self.alpha) for w, a, b in
                zip(self.w.unbind(0), self.a.unbind(0), self.b.unbind(0))]

    def reshape(self, *shape):
        """Leading-dim reshapes stay lazy; anything that touches the
        trailing matmul dims materializes."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = tuple(shape[0])
        tail = tuple(self.w.shape[-2:])
        if (len(shape) >= 2 and tuple(shape[-2:]) == tail
                and int(np.prod(shape)) == _numel(self.w)):
            lead = tuple(shape[:-2])
            return LoRATensor(self.w.reshape(lead + tail),
                              self.a.reshape(lead + tuple(self.a.shape[-2:])),
                              self.b.reshape(lead + tuple(self.b.shape[-2:])),
                              self.alpha)
        return self.materialize().reshape(shape)


DEFAULT_LORA_KEYS = ("wq", "wv")


def apply_lora(params: Dict[str, Any], keys: Sequence[str] = DEFAULT_LORA_KEYS,
               rank: int = 8, alpha: float = 16.0,
               seed: int = 0) -> Dict[str, Any]:
    """Attach rank-``rank`` adapters to ``keys`` (default: the attention
    q/v projections, the standard LoRA placement). ``A`` ~ N(0, 1/rank),
    drawn with numpy from ``seed`` as the reference draws it (the same
    bits), ``B`` = 0: the adapted model starts exactly at the base. The
    factors land on the base weight's device."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for name, value in params.items():
        if name not in keys:
            out[name] = value
            continue
        if isinstance(value, LoRATensor):
            if value.a.shape[-1] != rank or value.alpha != float(alpha):
                raise ValueError(
                    f"{name!r} already adapted with rank "
                    f"{value.a.shape[-1]}/alpha {value.alpha}; re-applying "
                    f"with rank {rank}/alpha {alpha} would silently keep "
                    "the old adapters — merge_lora first to re-adapt"
                )
            out[name] = value  # idempotent for matching config
            continue
        w = torch.as_tensor(value)
        if w.dim() < 2:
            raise ValueError(f"cannot adapt non-matrix param {name!r}")
        *lead, d_in, d_out = w.shape
        a = (rng.normal(size=(*lead, d_in, rank)).astype(np.float32)
             / np.sqrt(rank)).astype(np.float32)
        out[name] = LoRATensor(
            w, torch.from_numpy(a).to(w.device),
            torch.zeros((*lead, rank, d_out), dtype=torch.float32,
                        device=w.device),
            float(alpha))
    missing = [k for k in keys if k not in params]
    if missing:
        raise ValueError(f"keys not in params: {missing}")
    return out


def merge_lora(params: Dict[str, Any]) -> Dict[str, Any]:
    """Bake adapters into plain float32 tensors (deployment form)."""
    return {k: (v.materialize() if isinstance(v, LoRATensor) else v)
            for k, v in params.items()}


def lora_mask(params: Dict[str, Any]):
    """A tree of booleans shaped like ``params``: True on the trainable
    adapter factors, False on everything else, each adapter's frozen base
    included (``LoRATensor(False, True, True, alpha)`` for an adapted
    entry). For :func:`~elephas_tpu_torch.models.optimizers.masked` around
    a decay-style optimizer: weight decay is not gradient-driven, so
    detaching the base alone does not protect it."""
    return {k: (LoRATensor(False, True, True, v.alpha)
                if isinstance(v, LoRATensor) else False)
            for k, v in params.items()}


def lora_trainable_count(params: Dict[str, Any]) -> Tuple[int, int]:
    """(trainable adapter element count, total element count)."""
    trainable = total = 0
    for v in params.values():
        if isinstance(v, LoRATensor):
            trainable += _numel(v.a) + _numel(v.b)
            total += _numel(v.w) + _numel(v.a) + _numel(v.b)
        else:
            total += _numel(v)
    return trainable, total


def save_lora(path: str, params: Dict[str, Any]) -> None:
    """Persist ONLY the adapters as an npz, under the reference's keys
    (``<name>.a``, ``<name>.b``, ``<name>.alpha``), so a file moves both
    ways between the packages; reattach to any copy of the base with
    :func:`load_lora`. Full-state checkpointing of the whole adapted dict
    goes through ``utils.save_pytree``."""
    arrays: Dict[str, np.ndarray] = {}
    for name, v in params.items():
        if isinstance(v, LoRATensor):
            arrays[f"{name}.a"] = v.a.detach().cpu().numpy()
            arrays[f"{name}.b"] = v.b.detach().cpu().numpy()
            arrays[f"{name}.alpha"] = np.float32(v.alpha)
    if not arrays:
        raise ValueError("no LoRA adapters in params")
    np.savez(path, **arrays)


def load_lora(path: str, base_params: Dict[str, Any]) -> Dict[str, Any]:
    """Attach adapters saved by :func:`save_lora` onto ``base_params``
    (plain weights); the factors land on each base weight's device. Shapes
    are validated against the base."""
    if not str(path).endswith(".npz"):
        path = str(path) + ".npz"
    with np.load(path) as blob:
        names = sorted({k.rsplit(".", 1)[0] for k in blob.files})
        out = dict(base_params)
        for name in names:
            if name not in base_params:
                raise ValueError(f"adapter {name!r} has no base param")
            w = torch.as_tensor(base_params[name])
            a = torch.from_numpy(blob[f"{name}.a"]).to(w.device)
            b = torch.from_numpy(blob[f"{name}.b"]).to(w.device)
            if a.shape[:-1] != w.shape[:-1] or b.shape[-1] != w.shape[-1]:
                raise ValueError(
                    f"adapter {name!r} shaped {tuple(a.shape)}x"
                    f"{tuple(b.shape)} does not fit base {tuple(w.shape)}"
                )
            out[name] = LoRATensor(w, a, b, float(blob[f"{name}.alpha"]))
    return out


class MultiTenantLM(TransformerLM):
    """A :class:`TransformerLM` carrying ``n_adapters`` STACKED LoRA
    adapters for multi-tenant serving: one base model, many fine-tuned
    variants, selected PER BATCH ROW.

    The adapter factors live in the params dict as layer-stacked
    ``lora_w{t}_a`` ``[L, A, D, r]`` / ``lora_w{t}_b`` ``[L, A, r, out]``
    for each target projection ``t`` (q/k/v/o). :meth:`_attn_proj` adds
    ``(α/r)·(x@A[row])@B[row]`` while an adapter-row tensor is active,
    installed by :meth:`adapter_context` around a launch (the paged serving
    cache enters it around every insert, decode and verify). ``B`` starts
    at zero, so adapter 0 (and every fresh adapter) is exactly the base
    model: the serving engine's token identity for un-adapted tenants.
    Outside a context the model is the base model.

    Tenancy is a serving concept: training a single adapter goes through
    :func:`apply_lora` on a plain model; :meth:`load_adapter` installs the
    trained factors into one stack row here."""

    def __init__(self, *args, n_adapters: int = 4, lora_rank: int = 4,
                 lora_alpha: Optional[float] = None,
                 lora_targets: Sequence[str] = ("q", "v"), **kwargs):
        super().__init__(*args, **kwargs)
        if n_adapters < 1:
            raise ValueError(f"n_adapters must be >= 1, got {n_adapters}")
        if lora_rank < 1:
            raise ValueError(f"lora_rank must be >= 1, got {lora_rank}")
        targets = tuple(lora_targets)
        bad = [t for t in targets if t not in ("q", "k", "v", "o")]
        if bad or len(set(targets)) != len(targets):
            raise ValueError(
                f"lora_targets must be distinct members of q/k/v/o, "
                f"got {targets}")
        self.n_adapters = int(n_adapters)
        self.lora_rank = int(lora_rank)
        self.lora_alpha = float(2 * lora_rank if lora_alpha is None
                                else lora_alpha)
        self.lora_targets = targets
        self._adapter_rows = None  # int64 [rows] tensor, or None

    # -- params ----------------------------------------------------------
    def _lora_out_dim(self, t: str) -> int:
        Dkv = (self.d_model // self.n_heads) * self.n_kv_heads
        return self.d_model if t in ("q", "o") else Dkv

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        shapes = super().param_shapes()
        L, A, D, r = (self.n_layers, self.n_adapters, self.d_model,
                      self.lora_rank)
        for t in self.lora_targets:
            shapes[f"lora_w{t}_a"] = (L, A, D, r)
            shapes[f"lora_w{t}_b"] = (L, A, r, self._lora_out_dim(t))
        return shapes

    def init(self, seed: int = 0,
             device=None) -> Dict[str, torch.Tensor]:
        """The base weights as :meth:`TransformerLM.init` draws them, then
        the LoRA convention (as :func:`apply_lora`): ``A`` ~ N(0, 1/r)
        from ``SeedSequence([seed, 0x10A])``, ``B`` = 0, the reference's
        bits."""
        out = super().init(seed, device)
        dev = next(iter(out.values())).device
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x10A]))
        shapes = self.param_shapes()
        for t in self.lora_targets:
            a_key, b_key = f"lora_w{t}_a", f"lora_w{t}_b"
            a = (rng.normal(size=shapes[a_key])
                 / np.sqrt(self.lora_rank)).astype(np.float32)
            out[a_key] = torch.from_numpy(a).to(dev)
            out[b_key] = torch.zeros(shapes[b_key], dtype=torch.float32,
                                     device=dev)
        return out

    def _block_keys(self):
        keys = super()._block_keys()
        extra = []
        for t in self.lora_targets:
            extra += [f"lora_w{t}_a", f"lora_w{t}_b"]
        return keys + tuple(extra)

    # -- the per-row hook -----------------------------------------------
    @contextlib.contextmanager
    def adapter_context(self, rows):
        """Activate per-row adapter selection: ``rows`` int ``[B]``, the
        adapter id of each batch row in every projection run inside the
        context (a device tensor is used as is, so entering costs no
        upload)."""
        prev = self._adapter_rows
        self._adapter_rows = torch.as_tensor(rows, device=self.device).to(
            torch.int64)
        try:
            yield
        finally:
            self._adapter_rows = prev

    def _attn_proj(self, lp, name: str, x):
        y = super()._attn_proj(lp, name, x)
        rows = self._adapter_rows
        if rows is None or name not in self.lora_targets:
            return y
        cd = x.dtype
        # lp slices are per-layer: [A, D, r] / [A, r, out]; gather each
        # row's factors, two thin products, the scaled residual delta
        a = lp[f"lora_w{name}_a"].to(cd)[rows]
        b = lp[f"lora_w{name}_b"].to(cd)[rows]
        scale = self.lora_alpha / self.lora_rank
        if x.dim() == 2:        # decode step: x [S, D]
            delta = torch.einsum("sd,sdr->sr", x, a)
            delta = torch.einsum("sr,sro->so", delta, b)
        else:                   # prefill/chunk: x [S, T, D]
            delta = torch.einsum("std,sdr->str", x, a)
            delta = torch.einsum("str,sro->sto", delta, b)
        return y + scale * delta.to(cd)

    # -- host helpers ----------------------------------------------------
    def _check_adapter(self, adapter_id: int) -> None:
        if not 0 <= adapter_id < self.n_adapters:
            raise ValueError(f"adapter_id {adapter_id} out of range "
                             f"[0, {self.n_adapters})")

    def load_adapter(self, params: Dict[str, Any], adapter_id: int,
                     factors: Dict[str, Tuple[Any, Any]]) -> Dict[str, Any]:
        """Install trained factors into stack row ``adapter_id``:
        ``factors`` maps target letter → ``(a [L, D, r], b [L, r, out])``.
        Returns a new params dict (the stacks are copied, not mutated)."""
        self._check_adapter(adapter_id)
        out = dict(params)
        for t, (a, b) in factors.items():
            if t not in self.lora_targets:
                raise ValueError(f"{t!r} is not an adapted target "
                                 f"{self.lora_targets}")
            for key, new in ((f"lora_w{t}_a", a), (f"lora_w{t}_b", b)):
                stack = torch.as_tensor(out[key])
                new = torch.as_tensor(new).to(dtype=stack.dtype,
                                              device=stack.device)
                row = stack.shape[:1] + stack.shape[2:]
                if new.shape != row:
                    raise ValueError(f"{key} row must be {tuple(row)}, got "
                                     f"{tuple(new.shape)}")
                stack = stack.clone()
                stack[:, adapter_id] = new
                out[key] = stack
        return out

    def randomize_adapter(self, params: Dict[str, Any], adapter_id: int,
                          seed: int = 0, scale: float = 0.02) -> Dict[str, Any]:
        """Give adapter ``adapter_id`` a nonzero delta (small random ``B``
        from ``SeedSequence([seed, adapter_id])``, the reference's bits):
        the test and measurement shortcut for 'a tenant whose outputs must
        differ from the base'."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, adapter_id]))
        factors = {}
        for t in self.lora_targets:
            a = params[f"lora_w{t}_a"][:, adapter_id]
            shape = tuple(params[f"lora_w{t}_b"].shape)
            b = (rng.normal(size=shape[0:1] + shape[2:]) * scale).astype(
                np.float32)
            factors[t] = (a, b)
        return self.load_adapter(params, adapter_id, factors)

    def merged_params(self, params: Dict[str, Any],
                      adapter_id: int) -> Dict[str, Any]:
        """Bake ONE adapter into plain dense weights: the single-tenant
        deployment form, and the equivalence oracle of the tests (the
        merged model's outputs match the batched delta path)."""
        self._check_adapter(adapter_id)
        scale = self.lora_alpha / self.lora_rank
        out = {k: v for k, v in params.items() if not k.startswith("lora_")}
        for t in self.lora_targets:
            a = params[f"lora_w{t}_a"][:, adapter_id].to(torch.float32)
            b = params[f"lora_w{t}_b"][:, adapter_id].to(torch.float32)
            out[f"w{t}"] = params[f"w{t}"] + scale * torch.einsum(
                "ldr,lro->ldo", a, b)
        return out

    def base_model(self) -> TransformerLM:
        """The architecture-equal plain :class:`TransformerLM` on the same
        device (for ``merged_params`` consumers: its param shapes match the
        merged dict exactly)."""
        dtype_name = next(k for k, v in _DTYPES.items()
                          if v == self.compute_dtype)
        return TransformerLM(
            self.vocab, self.d_model, self.n_heads, self.n_layers,
            self.d_ff, self.max_len, compute_dtype=dtype_name,
            pos_encoding=self.pos_encoding,
            tie_embeddings=self.tie_embeddings,
            n_kv_heads=self.n_kv_heads, activation=self.activation,
            norm=self.norm, norm_eps=self.norm_eps,
            attn_bias=self.attn_bias, ffn_bias=self.ffn_bias,
            rope_theta=self.rope_theta,
            attn_window=(self.attn_windows if self.mixed_window
                         else self.attn_window),
            device=self.device,
        )


def build_lora_lm_train_step(model: TransformerLM, mesh, optimizer,
                             attn: str = "ring",
                             vocab_block: Optional[int] = None):
    """A fine-tuning step over a LoRA-adapted params dict on one device.

    Returns ``(step, opt_init)``: ``step(params, opt_state, tokens,
    positions, targets) -> (params, opt_state, loss)``, ``loss`` the
    token-mean cross-entropy as a 0-d tensor on the device, and
    ``opt_init(params) -> opt_state``. ``step.grad(params, tokens,
    positions, targets) -> (loss, grads)`` is the forward and backward
    alone; ``grads`` is shaped like ``params``, ``LoRATensor(None, da, db,
    alpha)`` on an adapted entry and ``None`` elsewhere. Like
    :func:`~elephas_tpu_torch.models.transformer.build_lm_train_step`, but
    the gradient is taken with respect to the adapter factors alone: no
    gradient of a frozen weight is ever computed (the reference computes
    and zeroes them), and the frozen tensors come back as the same objects,
    bit-identical. The optimizer is wrapped in
    :func:`~elephas_tpu_torch.models.optimizers.masked` over
    :func:`lora_mask`, so its state exists only for the factors and a
    decay-style optimizer cannot touch the base. No ``accum_steps``:
    shrink the batch instead.

    ``mesh`` must be ``None``; ``attn="ring"`` (the default, kept from the
    reference) and ``"ulysses"`` raise ``NotImplementedError`` (sequence
    parallelism is not ported yet); ``attn="flash"`` runs the
    flash-attention kernels, the rope-on-load ones for a rotary model.
    ``vocab_block`` streams the loss head in vocab-column chunks
    (:func:`chunked_summed_xent`), the fine-tuning memory lever for large
    vocabularies. A mixture-of-experts model raises
    ``NotImplementedError``."""
    if getattr(model, "moe", None) is not None:
        raise NotImplementedError(
            "LoRA fine-tuning targets the dense TransformerLM family"
        )
    _validate_lm_step(model, mesh, attn)

    def masked_optimizer(params):
        return masked(optimizer, lora_mask(params))

    def objective(params, tokens, positions, targets):
        ntok = float(tokens.numel())
        if vocab_block is not None:
            h, _ = model.apply_hidden(params, tokens, positions, attn=attn)
            w = model.head_weight(params)
            if isinstance(w, LoRATensor):  # an untied adapted head
                w = w.materialize()
            return chunked_summed_xent(h, w, targets, vocab_block) / ntok
        logits = model.apply(params, tokens, positions, attn=attn)
        return _summed_xent(logits, targets) / ntok

    def grad(params, tokens, positions, targets):
        dev = params["tok"].device
        batch = tuple(_as_index(a, dev) for a in (tokens, positions, targets))
        _check_seq_len(model, batch[0].shape[1])
        live: Dict[str, Any] = dict(params)
        for k, v in params.items():
            if isinstance(v, LoRATensor):
                live[k] = LoRATensor(v.w, v.a.detach().requires_grad_(True),
                                     v.b.detach().requires_grad_(True),
                                     v.alpha)
        adapted = [k for k, v in live.items() if isinstance(v, LoRATensor)]
        if not adapted:
            raise ValueError("no LoRA adapters in params (apply_lora first)")
        loss = objective(live, *batch)
        g = torch.autograd.grad(
            loss, [t for k in adapted for t in (live[k].a, live[k].b)])
        grads: Dict[str, Any] = dict.fromkeys(params)
        for i, k in enumerate(adapted):
            grads[k] = LoRATensor(None, g[2 * i], g[2 * i + 1], params[k].alpha)
        return loss.detach(), grads

    def step(params, opt_state, tokens, positions, targets):
        loss, grads = grad(params, tokens, positions, targets)
        updates, opt_state = masked_optimizer(params).update(
            grads, opt_state, params)
        del grads
        new = dict(params)
        for k, u in updates.items():
            if u is not None:
                v = params[k]
                new[k] = LoRATensor(v.w, (v.a + u.a).to(v.a.dtype),
                                    (v.b + u.b).to(v.b.dtype), v.alpha)
        return new, opt_state, loss

    step.grad = grad

    def opt_init(params):
        # masked init: moment buffers exist only for the adapter factors
        return masked_optimizer(params).init(params)

    return step, opt_init
