"""Sliding-window attention in the port against the JAX package on the same
weights (``from_jax_params``), uniform and per layer, with the rolling
caches of all-windowed models.

- The window's normalisation: ``attn_windows``, ``mixed_window``, the
  uniform view, ``_ring_cache``, ``_max_window``, ``_window_period`` and
  the reference's ``ValueError``s.
- The teacher-forced forward (``dense`` and ``flash``), the windowed train
  step's loss and gradients, and the MoE variant with per-layer windows.
- The rolling cache: its shape, its slots after ``prefill`` through both
  branches of ``write_prompt_cache`` and after decode steps past the wrap,
  greedy ``generate`` past the wrap, ``decode_chunk`` on a margined ring
  and its margin ``ValueError``, windowed ``generate_speculative``.
- A mixed-window model (a full-attention layer, so a linear cache) in the
  dense and paged ``ServingEngine``, against the reference's engine; the
  all-windowed refusals of the slot and paged caches.

Tolerances are the reference tests' (``tests/models/test_mixed_window.py``,
``test_architectures.py``): logits and caches within 1e-4 across the two
frameworks, tokens exactly where every top-2 logit gap exceeds 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import transformer as jt
from elephas_tpu.serving import ServingEngine as JaxEngine
from elephas_tpu.serving import cache as jcache
from elephas_tpu.serving import memory as jmemory
from elephas_tpu_torch.models import (MoETransformerLM, TransformerLM,
                                      adam_compact, build_lm_train_step,
                                      from_jax_params, make_lm_batches)
from elephas_tpu_torch.models.transformer import write_prompt_cache
from elephas_tpu_torch.serving import PagedKVCache, ServingEngine, SlotKVCache

V = 61
BASE = dict(vocab=V, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, max_len=64,
            pos_encoding="rotary", norm="rmsnorm", activation="swiglu",
            ffn_bias=False, attn_bias=False)
TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3


def _cfg(windows):
    n = len(windows) if isinstance(windows, (tuple, list)) else 2
    return dict(BASE, n_layers=n, attn_window=windows)


def _pair(windows, seed=1, **kw):
    cfg = dict(_cfg(windows), **kw)
    jm = jt.TransformerLM(**cfg)
    npp = jm.init(seed)
    return (jm, {k: jnp.asarray(v) for k, v in npp.items()},
            TransformerLM(**cfg, device="cpu"), from_jax_params(npp, device="cpu"))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- normalisation ---------------------------------------------------------------


@pytest.mark.parametrize("windows", [None, 6, (8, 8), (None, 6, None, 6),
                                     (4, 8, 4, 8), (None, None, 6)],
                         ids=str)
def test_window_normalisation_matches_reference(windows):
    cfg = dict(BASE, n_layers=len(windows) if isinstance(windows, tuple) else 2,
               attn_window=windows)
    jm, tm = jt.TransformerLM(**cfg), TransformerLM(**cfg, device="cpu")
    for name in ("attn_windows", "mixed_window", "attn_window", "_ring_cache",
                 "_max_window"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm._window_period() == jm._window_period()


@pytest.mark.parametrize("windows", [0, (8,), (0, 8)], ids=str)
def test_window_errors_match_reference(windows):
    cfg = dict(BASE, n_layers=2, attn_window=windows)
    with pytest.raises(ValueError) as want:
        jt.TransformerLM(**cfg)
    with pytest.raises(ValueError) as got:
        TransformerLM(**cfg, device="cpu")
    assert str(got.value) == str(want.value)


# -- the teacher-forced forward and training ------------------------------------


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("windows", [6, (None, 6), (4, 8)], ids=str)
def test_windowed_apply_matches_reference(windows, attn):
    jm, jp, tm, tp = _pair(windows)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, V, size=(2, 24))
    pos = np.broadcast_to(np.arange(24), (2, 24))
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens), jnp.asarray(pos), attn="dense"))
    got = _np(tm.apply(tp, tokens, pos, attn=attn))
    np.testing.assert_allclose(got, want, **TOL)
    # the window binds: the same weights without it give other logits
    full = TransformerLM(**dict(_cfg(windows), attn_window=None), device="cpu")
    assert np.abs(_np(full.apply(tp, tokens, pos, attn=attn)) - got).max() > 1e-3


def test_uniform_callers_refuse_a_mixed_model():
    """``_attend`` without a window is the uniform view, and a mixed model
    raises there, as the reference's ``_UNIFORM_WINDOW`` rule does."""
    _, _, tm, _ = _pair((None, 6))
    q = torch.zeros(1, 4, 4, 8)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="per-layer window"):
        tm._attend(q, k, k, "dense")


@pytest.mark.parametrize("windows", [6, (None, 6)], ids=str)
def test_windowed_train_step_matches_reference(windows):
    """One step's loss and gradients on ``attn="flash"`` against the
    reference's ``value_and_grad`` of the same objective (the token-mean
    cross-entropy), from the same weights and tokens."""
    jm, jp, tm, tp = _pair(windows, seed=2)
    rows = np.random.default_rng(4).integers(0, V, size=(2, 21))
    tokens, positions, targets = make_lm_batches(rows)
    step, _ = build_lm_train_step(tm, None, adam_compact(1e-3), attn="flash")
    loss, grads = step.grad(tp, tokens, positions, targets)
    ntok = tokens.size

    def objective(p):
        return jm.loss(p, jnp.asarray(tokens), jnp.asarray(positions),
                       jnp.asarray(targets), attn="flash") / ntok

    want_loss, want = jax.jit(jax.value_and_grad(objective))(jp)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k, g in want.items():
        g = np.asarray(g)
        np.testing.assert_allclose(_np(grads[k]), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_moe_variant_accepts_per_layer_windows():
    """The reference's test of the same name, held to the reference: the
    MoE model with per-layer windows, its logits, aux and greedy tokens."""
    cfg = dict(vocab=V, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32,
               n_experts=4, k=1, pos_encoding="rotary", norm="rmsnorm",
               activation="swiglu", ffn_bias=False, attn_window=[None, 6])
    jm = jt.MoETransformerLM(**cfg)
    npp = jm.init(0)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tm = MoETransformerLM(**cfg, device="cpu")
    tp = from_jax_params(npp, device="cpu")
    assert tm.attn_windows == (None, 6) and tm.mixed_window
    tokens = np.random.default_rng(2).integers(0, V, size=(1, 16))
    pos = np.arange(16)[None]
    jl, jaux = jm.apply_with_aux(jp, jnp.asarray(tokens), jnp.asarray(pos))
    tl, taux = tm.apply_with_aux(tp, tokens, pos)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    out = tm.generate(tp, tokens[:, :3], 6)
    assert tuple(out.shape) == (1, 9)


# -- the rolling cache -------------------------------------------------------------


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("t0", [5, 13])
def test_write_prompt_cache_matches_reference(t0, windowed):
    """Both branches: the contiguous write, and a prompt longer than an
    8-slot ring keeping its last 8 positions at ``p mod 8``; in place, and
    the same tensors returned."""
    rng = np.random.default_rng(t0)
    kc, vc = (rng.normal(size=(2, 1, 2, 16 if t0 > 8 and not windowed else 8, 4))
              .astype(np.float32) for _ in range(2))
    ks, vs = (rng.normal(size=(2, 1, 2, t0, 4)).astype(np.float32)
              for _ in range(2))
    want = jt.write_prompt_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks),
                                 jnp.asarray(vs), windowed)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = write_prompt_cache(tk, tv, torch.from_numpy(ks), torch.from_numpy(vs),
                             windowed)
    assert got[0] is tk and got[1] is tv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("windows", [6, (4, 8), (None, 6)], ids=str)
@pytest.mark.parametrize("length,chunk", [(40, 1), (40, 4), (5, 1)])
def test_init_cache_shape_matches_reference(windows, length, chunk):
    jm, _, tm, _ = _pair(windows)
    assert tuple(tm.init_cache(2, length, chunk)["k"].shape) == \
        jm.init_cache(2, length, chunk)["k"].shape


@pytest.fixture(scope="module")
def ring6():
    """A uniform window of 6 in both packages, and the reference's
    ``prefill`` / ``decode_step`` / ``decode_chunk`` compiled once for the
    tests that walk its rolling cache."""
    jm, jp, tm, tp = _pair(6, seed=3)
    return (jm, jp, tm, tp, jax.jit(jm.prefill), jax.jit(jm.decode_step),
            jax.jit(jm.decode_chunk))


@pytest.mark.parametrize("t0", [5, 13], ids=["contiguous", "scatter"])
def test_ring_prefill_and_decode_slots_match_reference(ring6, t0):
    """A uniform window of 6 rolls over 8 slots: the prefill's logits and
    every slot, then 6 decode steps (past the ring's wrap) with their
    logits and slots, against the reference."""
    jm, jp, tm, tp, j_prefill, j_step, _ = ring6
    rng = np.random.default_rng(t0)
    prompt = rng.integers(0, V, size=(2, t0))
    jl, jc = j_prefill(jp, jnp.asarray(prompt), jm.init_cache(2, 40))
    tc = tm.init_cache(2, 40)
    assert tc["k"].shape[3] == 8
    tl, tc = tm.prefill(tp, torch.from_numpy(prompt), tc)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tc[n]), np.asarray(jc[n]), **TOL)
    for p in range(t0, t0 + 6):
        tok = rng.integers(0, V, size=(2,))
        jl, jc = j_step(jp, jnp.asarray(tok), jnp.asarray(p), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), p, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tc[n]), np.asarray(jc[n]), **TOL)


def _margins(tm, tp, out, t0):
    """The smallest top-2 logit gap over the generated positions, from the
    teacher-forced dense forward (the reference's to 1e-4, above)."""
    pos = np.broadcast_to(np.arange(out.shape[1] - 1), (out.shape[0], out.shape[1] - 1))
    logits = _np(tm.apply(tp, out[:, :-1], pos))
    top2 = np.sort(logits[:, t0 - 1:], axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]).min()


@pytest.mark.parametrize("windows", [6, (4, 8), (None, 6)], ids=str)
def test_greedy_generate_matches_reference_past_the_wrap(windows):
    """20 new tokens after 4: the all-windowed models' rings (8 and 16
    slots) wrap, the mixed one decodes on a linear cache."""
    jm, jp, tm, tp = _pair(windows, seed=2)
    prompt = np.random.default_rng(5).integers(0, V, size=(2, 4)).astype(np.int32)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), 20))
    got = _np(tm.generate(tp, prompt, 20))
    assert _margins(tm, tp, want, 4) > MARGIN
    np.testing.assert_array_equal(got, want)


def test_decode_chunk_on_a_margined_ring_matches_reference(ring6):
    """``init_cache(chunk=4)``: a 16-slot ring for a window of 6; a 13-token
    prompt, then two 4-token chunks, the second across the wrap, with
    per-row positions; logits and slots against the reference. A ring
    without the margin raises the reference's ``ValueError``."""
    jm, jp, tm, tp, j_prefill, _, j_chunk = ring6
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, V, size=(2, 13))
    jl, jc = j_prefill(jp, jnp.asarray(prompt), jm.init_cache(2, 40, chunk=4))
    tc = tm.init_cache(2, 40, chunk=4)
    assert tc["k"].shape[3] == 16
    _, tc = tm.prefill(tp, torch.from_numpy(prompt), tc)
    for pos0 in (np.array([13, 13]), np.array([17, 15])):
        toks = rng.integers(0, V, size=(2, 4))
        jl, jc = j_chunk(jp, jnp.asarray(toks), jnp.asarray(pos0), jc)
        tl, tc = tm.decode_chunk(tp, torch.from_numpy(toks), torch.from_numpy(pos0), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(tc[n]), np.asarray(jc[n]), **TOL)
    toks = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError) as want:
        jm.decode_chunk(jp, jnp.asarray(toks), 13, jm.init_cache(1, 40))
    with pytest.raises(ValueError) as got:
        tm.decode_chunk(tp, torch.from_numpy(toks), 13, tm.init_cache(1, 40))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("host_loop", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("windows", [6, (None, 6)], ids=str)
def test_windowed_speculative_equals_greedy(windows, host_loop):
    """A windowed target with a self-draft at ``spec_k=3``, 16 new tokens
    after 4: the margined ring (all-windowed) and the linear cache (mixed)
    emit the port's greedy tokens (the reference's, past the wrap, in
    ``test_greedy_generate_matches_reference_past_the_wrap``)."""
    _, _, tm, tp = _pair(windows, seed=2)
    prompt = np.random.default_rng(5).integers(0, V, size=(2, 4)).astype(np.int32)
    want = _np(tm.generate(tp, prompt, 16))
    got = tm.generate_speculative(tp, prompt, 16, tm, tp, spec_k=3,
                                  host_loop=host_loop)
    np.testing.assert_array_equal(_np(got), want)


# -- serving -------------------------------------------------------------------------


def _run(eng, reqs):
    ids = [eng.submit(p, n) for p, n in reqs]
    eng.drain()
    return [eng.result(r).tokens for r in ids]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_window_engine_matches_reference(paged):
    """A Qwen2-style mixed model (a window of 6 on the second layer, the
    first attending fully) serves on a linear cache through the dense and
    the paged engine; each stream equals the reference engine's."""
    jm, jp, tm, tp = _pair((None, 6), seed=1)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, V, size=(n,)).astype(np.int32), 12) for n in (5, 14, 9)]
    kw = dict(n_slots=2, paged=paged, page_size=8)
    got = _run(ServingEngine(tm, tp, device="cpu", **kw), reqs)
    assert got == _run(JaxEngine(jm, jp, **kw), reqs)


def test_all_windowed_models_are_refused_where_the_reference_refuses():
    """A model whose every layer is windowed rolls its cache: the slot and
    paged caches, ``prefill_slot`` and the paged decode paths refuse it, as
    the reference's do."""
    jm, jp, tm, tp = _pair(6)
    for port, ref in ((SlotKVCache, jcache.SlotKVCache),
                      (PagedKVCache, jmemory.PagedKVCache)):
        with pytest.raises(NotImplementedError, match="linear"):
            ref(jm, jp, 2)
        with pytest.raises(NotImplementedError, match="linear"):
            port(tm, tp, 2)
    tok = torch.zeros(1, 3, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="linear"):
        tm.prefill_slot(tp, tok, 0, tm.init_cache(1, 16))
    pool = {n: torch.zeros(2, 4, 2, 8, 8) for n in ("k", "v")}
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="linear-horizon"):
        tm.decode_step_paged(tp, tok[:, 0], 0, pool, table, 8)
    with pytest.raises(ValueError, match="linear-horizon"):
        tm.decode_chunk_paged(tp, tok, 0, pool, table, 8)
    with pytest.raises(NotImplementedError, match="linear"):
        ServingEngine(tm, tp, n_slots=2, device="cpu")
