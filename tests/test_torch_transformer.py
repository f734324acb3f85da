"""The port's TransformerLM serving path against the JAX package's, on the
same weights and tokens: ``init`` draws, parameter conversion, and the
logits and KV caches of ``decode_chunk``, ``decode_step`` and
``prefill_slot`` for a GPT-2-shaped and a Llama-shaped configuration. The
tolerance, atol/rtol 1e-4, allows float32 sums taken in another order
across layers."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models.transformer import TransformerLM as JaxLM
from elephas_tpu_torch.models import (MoETransformerLM, TransformerLM,
                                      from_jax_params, to_numpy)

V = 17
BASE = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
CONFIGS = {
    # GPT-2 family: gelu + layernorm + biases + learned positions + tied
    "gpt2": dict(BASE, activation="gelu", norm="layernorm", attn_bias=True,
                 ffn_bias=True, pos_encoding="learned", tie_embeddings=True),
    # Llama family: swiglu + rmsnorm + no biases + rotary + GQA
    "llama": dict(BASE, activation="swiglu", norm="rmsnorm", attn_bias=False,
                  ffn_bias=False, pos_encoding="rotary", n_kv_heads=2,
                  rope_theta=500000.0),
}
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(name, seed=1):
    """(jax model, jax params, port model, port params) on equal weights.
    Norm scales and biases are perturbed off their init constants so every
    affine and bias path carries signal."""
    cfg = CONFIGS[name]
    jm, tm = JaxLM(**cfg), TransformerLM(**cfg, device="cpu")
    rng = np.random.default_rng(seed + 100)
    npp = {k: (v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
               if k.startswith(("ln", "b")) else v)
           for k, v in jm.init(seed).items()}
    return (jm, {k: jnp.asarray(v) for k, v in npp.items()},
            tm, from_jax_params(npp, device="cpu"))


def _close_cache(jc, tc):
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_bitwise_equal_and_roundtrip(name):
    cfg = CONFIGS[name]
    want = JaxLM(**cfg).init(7)
    port = TransformerLM(**cfg, device="cpu").init(7)
    assert list(port) == list(want)
    got = to_numpy(port)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = to_numpy(from_jax_params(got, device="cpu"))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_chunk_then_steps_match(name):
    """A prompt chunk, a second chunk continuing it, then per-row and
    scalar decode steps: logits and caches track the JAX model."""
    jm, jp, tm, tp = _pair(name)
    rng = np.random.default_rng(0)
    B = 3
    jc, tc = jm.init_cache(B, 40), tm.init_cache(B, 40)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)

    toks = rng.integers(0, V, size=(B, 6))
    jl, jc = jm.decode_chunk(jp, jnp.asarray(toks), 0, jc)
    tl, tc = tm.decode_chunk(tp, torch.from_numpy(toks), 0, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(jc, tc)

    pos0 = np.array([6, 6, 6], np.int32)
    toks = rng.integers(0, V, size=(B, 4))
    jl, jc = jm.decode_chunk(jp, jnp.asarray(toks), jnp.asarray(pos0), jc)
    tl, tc = tm.decode_chunk(tp, torch.from_numpy(toks),
                             torch.from_numpy(pos0), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(jc, tc)

    for pos in (np.array([10, 3, 7], np.int32), 11):
        tok = rng.integers(0, V, size=(B,))
        jpos = jnp.asarray(pos) if np.ndim(pos) else pos
        tpos = torch.from_numpy(pos) if np.ndim(pos) else pos
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jpos, jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tpos, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close_cache(jc, tc)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_slot_touches_only_its_row(name):
    jm, jp, tm, tp = _pair(name, seed=3)
    rng = np.random.default_rng(4)
    jc, tc = jm.init_cache(4, 40), tm.init_cache(4, 40)
    for slot, n, pos0 in ((2, 8, 0), (0, 5, 0), (2, 4, 8)):
        toks = rng.integers(0, V, size=(1, n))
        jl, jc = jm.prefill_slot(jp, jnp.asarray(toks), slot, jc, pos0=pos0)
        tl, tc = tm.prefill_slot(tp, torch.from_numpy(toks), slot, tc,
                                 pos0=pos0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close_cache(jc, tc)
    assert not tc["k"][:, [1, 3]].any()     # untouched rows stay zero


def test_bfloat16_compute_tracks_jax():
    """bf16 activations and cache on both sides: logits stay float32 and
    within a few bf16 roundings (2**-8 relative) of the JAX model's —
    atol/rtol 5e-2, inside the reference's own bf16-vs-f32 pin
    (tests/models/test_transformer.py, atol 0.15 / rtol 0.1)."""
    cfg = dict(CONFIGS["llama"], compute_dtype="bfloat16")
    jm, tm = JaxLM(**cfg), TransformerLM(**cfg, device="cpu")
    npp = jm.init(1)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = from_jax_params(npp, device="cpu")
    rng = np.random.default_rng(5)
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40)
    assert tc["k"].dtype == torch.bfloat16
    toks = rng.integers(0, V, size=(3, 6))
    jl, jc = jm.decode_chunk(jp, jnp.asarray(toks), 0, jc)
    tl, tc = tm.decode_chunk(tp, torch.from_numpy(toks), 0, tc)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2, rtol=5e-2)
    pos = np.array([6, 6, 6], np.int32)
    tok = rng.integers(0, V, size=(3,))
    jl, _ = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2, rtol=5e-2)


def test_attn_window_constructs_uniform_and_per_layer():
    """Sliding windows are ported: a uniform window and a per-layer list
    construct, with the reference's views of them (the per-layer tuple,
    the uniform scalar, the rolling-cache policy)."""
    uni = TransformerLM(**BASE, attn_window=8, device="cpu")
    assert uni.attn_windows == (8, 8) and uni.attn_window == 8
    assert uni._ring_cache and not uni.mixed_window and uni._max_window == 8
    mixed = TransformerLM(**BASE, attn_window=[4, None], device="cpu")
    assert mixed.attn_windows == (4, None) and mixed.attn_window is None
    assert mixed.mixed_window and not mixed._ring_cache


def test_later_slices_raise_not_implemented():
    """Sequence-parallel attention and expert parallelism are later slices
    (``apply``/``prefill``/``generate``, the single-device MoE LM, sliding
    windows and LoRA are ported since)."""
    tm = TransformerLM(**BASE, device="cpu")
    tokens = np.zeros((1, 4), np.int64)
    for attn in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.apply(tm.init(0), tokens, tokens, attn=attn)
    moe = MoETransformerLM(**BASE, n_experts=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.moe.apply(moe.moe.init(0, device="cpu"), torch.zeros(4, 16))
