"""The port's batched generation against the JAX package's on the same
weights: greedy ``generate`` token for token (with every position's top-2
logit margin asserted, so no near tie decides a token), ``prefill`` logits
and cache (atol/rtol 1e-4), the nucleus mask, and the sampler's contract:
``top_k=1`` is greedy, a seed fixes the draws, and a row's draws do not
depend on its batch neighbours. The draws themselves differ from
``jax.random``'s by design, so sampled tokens are not compared across the
packages."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import transformer as jt
from elephas_tpu_torch.models import (TransformerLM, from_jax_params,
                                      nucleus_mask)

V = 17
BASE = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
CONFIGS = {
    "gpt2": dict(BASE, activation="gelu", norm="layernorm", attn_bias=True,
                 ffn_bias=True, pos_encoding="learned", tie_embeddings=True),
    "llama": dict(BASE, activation="swiglu", norm="rmsnorm", attn_bias=False,
                  ffn_bias=False, pos_encoding="rotary", n_kv_heads=2,
                  rope_theta=500000.0),
}
TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3


def _pair(name, seed=2):
    jm = jt.TransformerLM(**CONFIGS[name])
    npp = jm.init(seed)
    return (jm, {k: jnp.asarray(v) for k, v in npp.items()},
            TransformerLM(**CONFIGS[name], device="cpu"),
            from_jax_params(npp, device="cpu"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_generate_token_identical_to_jax(name):
    jm, jp, tm, tp = _pair(name, seed=5)   # a seed whose rollouts hold no near tie
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, V, size=(3, 9)).astype(np.int32)
    n_new = 12
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), n_new))
    got = tm.generate(tp, prompt, n_new)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    # every emitted token is decided by a clear top-1/top-2 margin
    logits = np.asarray(jm.apply(jp, jnp.asarray(want[:, :-1]),
                                 jnp.broadcast_to(jnp.arange(want.shape[1] - 1),
                                                  (3, want.shape[1] - 1))))
    top2 = np.sort(logits[:, prompt.shape[1] - 1:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_logits_and_cache_match_jax(name):
    jm, jp, tm, tp = _pair(name, seed=3)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, V, size=(2, 11))
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(2, 20))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(2, 20))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


@pytest.mark.parametrize("top_p", [0.3, 0.8, 0.95])
def test_nucleus_mask_matches_jax(top_p):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(6, V)) * 2).astype(np.float32)
    want = np.asarray(jt.nucleus_mask(jnp.asarray(logits), top_p))
    got = nucleus_mask(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_nucleus_mask_cuts_tied_boundary_logits_by_rank():
    """The reference's pin: a boundary logit's tied duplicate outside the
    prefix is cut by rank, and the result equals the reference's mask."""
    logits = np.log(np.asarray([[0.5, 0.25, 0.25, 1e-9],
                                [0.97, 0.01, 0.01, 0.01]], np.float32))
    got = nucleus_mask(torch.from_numpy(logits), 0.7).numpy()
    assert got[0, 0] and not got[0, 3] and bool(got[0, 1]) ^ bool(got[0, 2])
    assert got[1].tolist() == [True, False, False, False]
    np.testing.assert_array_equal(
        got, np.asarray(jt.nucleus_mask(jnp.asarray(logits), 0.7)))


def test_sampling_contract():
    """Greedy at temperature 0; top_k=1 and a vanishing top_p collapse to
    greedy; a seed fixes the draws; top_p=1 is plain temperature sampling."""
    _, _, tm, tp = _pair("gpt2", seed=4)
    prompt = np.array([[5, 6, 7], [1, 2, 3]], np.int32)
    greedy = tm.generate(tp, prompt, 8)
    a = tm.generate(tp, prompt, 8, temperature=1.5, seed=7)
    assert torch.equal(a, tm.generate(tp, prompt, 8, temperature=1.5, seed=7))
    assert not torch.equal(a, tm.generate(tp, prompt, 8, temperature=1.5, seed=8))
    assert torch.equal(a[:, :3], torch.from_numpy(prompt))
    assert bool(((a >= 0) & (a < V)).all())
    assert torch.equal(tm.generate(tp, prompt, 8, temperature=1.5, top_k=1,
                                   seed=9), greedy)
    assert torch.equal(tm.generate(tp, prompt, 8, temperature=1.5, top_p=1e-6,
                                   seed=7), greedy)
    assert torch.equal(tm.generate(tp, prompt, 8, temperature=1.5, top_p=1.0,
                                   seed=7), a)
    ck = tm.generate(tp, prompt, 8, temperature=1.5, top_k=5, top_p=0.9, seed=7)
    assert bool(((ck >= 0) & (ck < V)).all())


def test_row_draws_independent_of_batch_neighbours():
    """Draws are keyed by (seed, row, position): row 0 samples the same
    tokens beside any neighbour."""
    _, _, tm, tp = _pair("llama", seed=5)
    rng = np.random.default_rng(6)
    row0 = rng.integers(0, V, size=(1, 5))
    tokens = []
    for _ in range(2):
        batch = np.concatenate([row0, rng.integers(0, V, size=(2, 5))])
        tokens.append(tm.generate(tp, batch, 10, temperature=2.0, seed=3)[0])
    assert torch.equal(tokens[0], tokens[1])


def test_generate_validates_length_top_k_and_top_p():
    tm = TransformerLM(**dict(CONFIGS["gpt2"], max_len=8), device="cpu")
    params = tm.init(0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tm.generate(params, np.zeros((1, 6), np.int32), n_new=4)
    for bad in (0, 100):
        with pytest.raises(ValueError, match="top_k"):
            tm.generate(params, np.zeros((1, 2), np.int32), n_new=2,
                        temperature=1.0, top_k=bad)
    for bad_p in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError, match="top_p"):
            tm.generate(params, np.zeros((1, 2), np.int32), n_new=2,
                        temperature=1.0, top_p=bad_p)
