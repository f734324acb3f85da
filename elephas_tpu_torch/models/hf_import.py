"""Import Hugging Face causal-LM checkpoints into :class:`TransformerLM`
(port of ``elephas_tpu/models/hf_import.py``).

A ``transformers`` causal LM (GPT-2-, Llama-, Mistral-, Qwen2- or
Mixtral-family) converts into the port's :class:`TransformerLM` /
:class:`MoETransformerLM` and its param dict in the layout both packages
share (numpy float32, the same names and stacked ``[L, ...]`` shapes), after
which everything in the port applies unchanged: the serving engine and its
kernels, int8 quantization (``models/quantize.py``), LoRA, speculative
decoding. Any object with ``.config`` and ``.state_dict()`` converts (a
``transformers`` model is read duck-typed); ``transformers`` itself is
imported only by :func:`load_hf_lm`, which loads a local checkpoint.

The conversion is exact: ``tests/test_torch_hf_import.py`` holds the
params to the reference's bit for bit and the logits and greedy tokens to
the Hugging Face model's own forward and ``generate``.

Architecture mapping (all resolved from the HF config, never guessed):

========  ==========================================================
family    TransformerLM configuration
========  ==========================================================
gpt2      gelu(tanh) + layernorm + attn/ffn biases + learned
          positions + tied embeddings; Conv1D weights are already
          ``[in, out]`` (no transpose)
llama     swiglu + rmsnorm + rotary (theta, GQA from config);
          ``nn.Linear`` weights transpose from ``[out, in]``
mistral   llama mapping + ``attn_window`` = the config's sliding
          window
qwen2     llama mapping + q/k/v biases (o bias zero-filled);
          ``attn_window`` when ``use_sliding_window``, including
          MIXED per-layer patterns (``layer_types`` /
          ``max_window_layers``) as a per-layer window list
mixtral   llama attention + sparse-MoE FFN → ``MoETransformerLM``
          (swiglu experts, top-k renormalized routing; capacity
          pinned to never bind so routing equals HF's exactly)
========  ==========================================================

RoPE convention: the port's LM and the HF Llama family both use the
HALF-SPLIT (NeoX) pairing (dim ``i`` rotates with ``i + Dh/2``), so q/k
weights need no permutation.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .. import DeviceLike
from .transformer import TransformerLM

__all__ = ["lm_from_hf", "load_hf_lm"]


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().astype(np.float32)


def _take(sd, key) -> np.ndarray:
    """Pop ``key`` from the state dict and convert to host f32.

    Popping (rather than indexing) lets :func:`load_hf_lm` free each torch
    tensor as soon as it is converted: once the torch model itself is
    released, the popped dict holds the only reference, so peak host RAM
    stays near one copy of the checkpoint instead of torch + numpy
    coexisting for the whole conversion.
    """
    return _np(sd.pop(key))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise NotImplementedError(f"hf_import: {what}")


def _from_gpt2(cfg, sd, compute_dtype: str, device: DeviceLike
               ) -> Tuple[TransformerLM, Dict[str, np.ndarray]]:
    _check(cfg.activation_function in ("gelu_new", "gelu_pytorch_tanh"),
           f"activation_function={cfg.activation_function!r} (GPT-2 family "
           "checkpoints use the tanh-approximated gelu)")
    _check(not getattr(cfg, "scale_attn_by_inverse_layer_idx", False),
           "scale_attn_by_inverse_layer_idx")
    _check(getattr(cfg, "scale_attn_weights", True),
           "scale_attn_weights=False (this framework always scales scores "
           "by 1/sqrt(head_dim); importing would silently change logits)")
    L, D = cfg.n_layer, cfg.n_embd
    model = TransformerLM(
        vocab=cfg.vocab_size, d_model=D, n_heads=cfg.n_head, n_layers=L,
        d_ff=4 * D if cfg.n_inner is None else cfg.n_inner,
        max_len=cfg.n_positions, pos_encoding="learned",
        tie_embeddings=True, activation="gelu", norm="layernorm",
        norm_eps=cfg.layer_norm_epsilon, attn_bias=True, ffn_bias=True,
        compute_dtype=compute_dtype, device=device,
    )
    pre = "transformer."
    params: Dict[str, Any] = {
        "tok": _take(sd, pre + "wte.weight"),
        "pos": _take(sd, pre + "wpe.weight"),
        "lnf_s": _take(sd, pre + "ln_f.weight"),
        "lnf_b": _take(sd, pre + "ln_f.bias"),
    }

    def stack(fmt):
        return np.stack([_take(sd, pre + fmt.format(i)) for i in range(L)])

    params["ln1_s"] = stack("h.{}.ln_1.weight")
    params["ln1_b"] = stack("h.{}.ln_1.bias")
    params["ln2_s"] = stack("h.{}.ln_2.weight")
    params["ln2_b"] = stack("h.{}.ln_2.bias")
    # Conv1D stores [in, out] — our layout exactly; qkv split by column.
    cattn_w = stack("h.{}.attn.c_attn.weight")        # [L, D, 3D]
    cattn_b = stack("h.{}.attn.c_attn.bias")          # [L, 3D]
    params["wq"], params["wk"], params["wv"] = (
        np.ascontiguousarray(a) for a in np.split(cattn_w, 3, axis=2))
    params["bq"], params["bk"], params["bv"] = (
        np.ascontiguousarray(a) for a in np.split(cattn_b, 3, axis=1))
    params["wo"] = stack("h.{}.attn.c_proj.weight")
    params["bo"] = stack("h.{}.attn.c_proj.bias")
    params["w1"] = stack("h.{}.mlp.c_fc.weight")
    params["b1"] = stack("h.{}.mlp.c_fc.bias")
    params["w2"] = stack("h.{}.mlp.c_proj.weight")
    params["b2"] = stack("h.{}.mlp.c_proj.bias")
    return model, params


def _from_llama_family(cfg, sd, family: str, compute_dtype: str,
                       device: DeviceLike
                       ) -> Tuple[TransformerLM, Dict[str, np.ndarray]]:
    _check(cfg.hidden_act == "silu", f"hidden_act={cfg.hidden_act!r}")
    _check(getattr(cfg, "rope_scaling", None) is None,
           f"rope_scaling={getattr(cfg, 'rope_scaling', None)!r}")
    _check(not getattr(cfg, "mlp_bias", False), "mlp_bias=True")
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    H = cfg.num_attention_heads
    _check(getattr(cfg, "head_dim", None) in (None, D // H),
           f"head_dim={getattr(cfg, 'head_dim', None)} != d_model/n_heads")
    max_len = cfg.max_position_embeddings
    window = getattr(cfg, "sliding_window", None)
    windowed = family == "mistral" and window is not None
    per_layer = None
    if (family == "qwen2" and window is not None
            and getattr(cfg, "use_sliding_window", False)):
        # Qwen2 windows only SOME layers (layer_types /
        # max_window_layers): import as a PER-LAYER attn_window list;
        # TransformerLM's per-layer windows make the import exact.
        lt = getattr(cfg, "layer_types", None)
        if lt is not None:
            sliding = [t == "sliding_attention" for t in lt]
        else:
            mwl = int(getattr(cfg, "max_window_layers", 0) or 0)
            sliding = [i >= mwl for i in range(cfg.num_hidden_layers)]
        if all(sliding):
            windowed = True
        elif any(sliding):
            per_layer = [window if s else None for s in sliding]
    attn_window = window if windowed else None
    if attn_window is not None and attn_window >= max_len:
        attn_window = None  # window never binds — plain causal attention
    if per_layer is not None:
        per_layer = [None if (w is not None and w >= max_len) else w
                     for w in per_layer]
        attn_window = (per_layer if any(w is not None for w in per_layer)
                       else None)
    # qwen2: q/k/v carry biases, o does not — zero-filling bo keeps the
    # math identical under our all-or-nothing attn_bias knob.
    qkv_bias = family == "qwen2" or getattr(cfg, "attention_bias", False)
    tie = bool(getattr(cfg, "tie_word_embeddings", False))
    model = TransformerLM(
        vocab=cfg.vocab_size, d_model=D, n_heads=H, n_layers=L,
        d_ff=cfg.intermediate_size, max_len=max_len,
        pos_encoding="rotary", rope_theta=getattr(cfg, "rope_theta", 10000.0),
        n_kv_heads=getattr(cfg, "num_key_value_heads", None) or H,
        tie_embeddings=tie, activation="swiglu", norm="rmsnorm",
        norm_eps=cfg.rms_norm_eps, attn_bias=qkv_bias, ffn_bias=False,
        attn_window=attn_window, compute_dtype=compute_dtype, device=device,
    )
    pre = "model."
    params: Dict[str, Any] = {
        "tok": _take(sd, pre + "embed_tokens.weight"),
        "lnf_s": _take(sd, pre + "norm.weight"),
    }
    if not tie:
        params["head"] = np.ascontiguousarray(_take(sd, "lm_head.weight").T)

    def stack(fmt, transpose=False):
        mats = [_take(sd, pre + fmt.format(i)) for i in range(L)]
        if transpose:  # nn.Linear stores [out, in]
            mats = [m.T for m in mats]
        return np.ascontiguousarray(np.stack(mats))

    params["ln1_s"] = stack("layers.{}.input_layernorm.weight")
    params["ln2_s"] = stack("layers.{}.post_attention_layernorm.weight")
    params["wq"] = stack("layers.{}.self_attn.q_proj.weight", True)
    params["wk"] = stack("layers.{}.self_attn.k_proj.weight", True)
    params["wv"] = stack("layers.{}.self_attn.v_proj.weight", True)
    params["wo"] = stack("layers.{}.self_attn.o_proj.weight", True)
    params["w1"] = stack("layers.{}.mlp.gate_proj.weight", True)
    params["w3"] = stack("layers.{}.mlp.up_proj.weight", True)
    params["w2"] = stack("layers.{}.mlp.down_proj.weight", True)
    if qkv_bias:
        params["bq"] = stack("layers.{}.self_attn.q_proj.bias")
        params["bk"] = stack("layers.{}.self_attn.k_proj.bias")
        params["bv"] = stack("layers.{}.self_attn.v_proj.bias")
        if pre + "layers.0.self_attn.o_proj.bias" in sd:
            params["bo"] = stack("layers.{}.self_attn.o_proj.bias")
        else:
            params["bo"] = np.zeros((L, D), np.float32)
    return model, params


def _from_mixtral(cfg, sd, compute_dtype: str, device: DeviceLike
                  ) -> Tuple[TransformerLM, Dict[str, np.ndarray]]:
    """Mixtral-family sparse-MoE checkpoints → :class:`MoETransformerLM`.

    Routing parity note: HF Mixtral softmaxes the router logits, takes the
    top-k probabilities, and renormalizes them — algebraically identical
    to this framework's ``token_choice`` combine weights *when capacity
    never binds*, so the import pins ``capacity_factor = E/k`` (a slot for
    every token; no drops). Serving deployments can lower it afterward —
    that is then GShard-style capacity-bounded Mixtral, a documented
    approximation, not the checkpoint's exact math.
    """
    from .transformer import MoETransformerLM

    _check(cfg.hidden_act == "silu", f"hidden_act={cfg.hidden_act!r}")
    _check(getattr(cfg, "rope_scaling", None) is None,
           f"rope_scaling={getattr(cfg, 'rope_scaling', None)!r}")
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    H = cfg.num_attention_heads
    _check(getattr(cfg, "head_dim", None) in (None, D // H),
           f"head_dim={getattr(cfg, 'head_dim', None)} != d_model/n_heads")
    E = cfg.num_local_experts
    k = cfg.num_experts_per_tok
    max_len = cfg.max_position_embeddings
    window = getattr(cfg, "sliding_window", None)
    if window is not None and window >= max_len:
        window = None
    model = MoETransformerLM(
        vocab=cfg.vocab_size, d_model=D, n_heads=H, n_layers=L,
        d_ff=cfg.intermediate_size, max_len=max_len,
        n_experts=E, k=k, capacity_factor=E / k,
        aux_weight=getattr(cfg, "router_aux_loss_coef", 0.0),
        pos_encoding="rotary", rope_theta=getattr(cfg, "rope_theta", 1e6),
        n_kv_heads=getattr(cfg, "num_key_value_heads", None) or H,
        tie_embeddings=bool(getattr(cfg, "tie_word_embeddings", False)),
        activation="swiglu", norm="rmsnorm", norm_eps=cfg.rms_norm_eps,
        attn_bias=False, ffn_bias=False, attn_window=window,
        compute_dtype=compute_dtype, device=device,
    )
    pre = "model."
    params: Dict[str, Any] = {
        "tok": _take(sd, pre + "embed_tokens.weight"),
        "lnf_s": _take(sd, pre + "norm.weight"),
    }
    if not model.tie_embeddings:
        params["head"] = np.ascontiguousarray(_take(sd, "lm_head.weight").T)

    def stack(fmt, transpose=False):
        mats = [_take(sd, pre + fmt.format(i)) for i in range(L)]
        if transpose:
            mats = [m.T for m in mats]
        return np.ascontiguousarray(np.stack(mats))

    def estack(fmt):  # [L, E, in, out] from per-expert [out, in] Linears
        return np.ascontiguousarray(np.stack([
            np.stack([_take(sd, pre + fmt.format(i, e)).T for e in range(E)])
            for i in range(L)
        ]))

    params["ln1_s"] = stack("layers.{}.input_layernorm.weight")
    params["ln2_s"] = stack("layers.{}.post_attention_layernorm.weight")
    params["wq"] = stack("layers.{}.self_attn.q_proj.weight", True)
    params["wk"] = stack("layers.{}.self_attn.k_proj.weight", True)
    params["wv"] = stack("layers.{}.self_attn.v_proj.weight", True)
    params["wo"] = stack("layers.{}.self_attn.o_proj.weight", True)
    params["wg"] = stack("layers.{}.block_sparse_moe.gate.weight", True)
    params["w1"] = estack("layers.{}.block_sparse_moe.experts.{}.w1.weight")
    params["w3"] = estack("layers.{}.block_sparse_moe.experts.{}.w3.weight")
    params["w2"] = estack("layers.{}.block_sparse_moe.experts.{}.w2.weight")
    return model, params


def lm_from_hf(hf_model, compute_dtype: str = "float32",
               device: DeviceLike = "cuda"
               ) -> Tuple[TransformerLM, Dict[str, np.ndarray]]:
    """Convert a loaded ``transformers`` causal LM (or any object with
    ``.config`` and ``.state_dict()``) → ``(model, params)``.

    ``params`` are host numpy (float32) in the :class:`TransformerLM`
    layout: move them to the model's device like any other params
    (``torch.from_numpy(v).to(device)``); ``model`` carries the
    architecture resolved from the HF config, on ``device``, with
    ``compute_dtype`` (``"float32"`` or ``"bfloat16"``) as its torch dtype.
    """
    return _convert(hf_model.config, hf_model.state_dict(),
                    compute_dtype=compute_dtype, device=device)


def _convert(cfg, sd, compute_dtype: str, device: DeviceLike = "cuda"
             ) -> Tuple[TransformerLM, Dict[str, np.ndarray]]:
    """Config + state-dict → ``(model, params)``; consumes ``sd`` (pops
    each tensor as it converts, so a caller that drops its own references
    first — :func:`load_hf_lm` — never holds torch and numpy copies of the
    whole checkpoint simultaneously)."""
    family = cfg.model_type
    if family == "gpt2":
        model, params = _from_gpt2(cfg, sd, compute_dtype, device)
    elif family in ("llama", "mistral", "qwen2"):
        model, params = _from_llama_family(cfg, sd, family, compute_dtype, device)
    elif family == "mixtral":
        model, params = _from_mixtral(cfg, sd, compute_dtype, device)
    else:
        raise NotImplementedError(
            f"hf_import supports gpt2/llama/mistral/qwen2/mixtral, got "
            f"model_type={family!r}"
        )
    expect = model.param_shapes()
    got = {k: v.shape for k, v in params.items()}
    want = {k: tuple(s) for k, s in expect.items()}
    if got != want:
        diff = {k: (got.get(k), want.get(k))
                for k in set(got) | set(want) if got.get(k) != want.get(k)}
        raise ValueError(f"hf_import shape mismatch: {diff}")
    return model, params


def load_hf_lm(name_or_path: str, compute_dtype: str = "float32",
               device: DeviceLike = "cuda", **kwargs
               ) -> Tuple[TransformerLM, Dict[str, np.ndarray]]:
    """``AutoModelForCausalLM.from_pretrained`` on a LOCAL checkpoint
    directory → :func:`lm_from_hf`.

    ``kwargs`` pass through to ``from_pretrained`` (e.g. ``torch_dtype``);
    ``device`` is the model's. ``local_files_only=True`` is always passed,
    so a hub name is never fetched.

    Host-RAM note: the torch module is released BEFORE conversion and
    each tensor is freed as it converts (see :func:`_take`), so peak host
    memory is ~one f32 copy of the checkpoint plus the largest single
    tensor — not torch + numpy coexisting. For very large checkpoints
    prefer ``torch_dtype="bfloat16"`` (halves the torch-side footprint;
    conversion still emits f32 numpy).
    """
    from transformers import AutoModelForCausalLM

    kwargs["local_files_only"] = True
    hf_model = AutoModelForCausalLM.from_pretrained(name_or_path, **kwargs)
    cfg = hf_model.config
    sd = hf_model.state_dict()
    del hf_model  # sd now holds the only references; _take frees as it goes
    return _convert(cfg, sd, compute_dtype=compute_dtype, device=device)
