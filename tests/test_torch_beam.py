"""``generate_beam`` in the port against the JAX package's on the same
weights, and the reference's own pins of it (``tests/models/test_beam.py``):
``beam_size=1`` is greedy ``generate`` exactly, a beam as wide as the
vocabulary finds the exhaustive optimum, a frozen beam repeats its EOS, the
rows of a batch are independent, and the validation errors. The
cross-framework cases run a rotary model with a sliding window of 5 (its
cache a rolling buffer whose rows move with their beams) at beam sizes 3
and 4, with EOS and a length penalty: sequences exactly, scores within
1e-4."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import generate_beam as jax_generate_beam
from elephas_tpu.models import transformer as jt
from elephas_tpu_torch.models import TransformerLM, from_jax_params, generate_beam

CFG = dict(vocab=12, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=24)
WINDOWED = dict(CFG, activation="swiglu", norm="rmsnorm", ffn_bias=False,
                pos_encoding="rotary", n_kv_heads=2, attn_window=5)


def _pair(cfg, seed):
    jm = jt.TransformerLM(**cfg)
    npp = jm.init(seed)
    return (jm, {k: jnp.asarray(v) for k, v in npp.items()},
            TransformerLM(**cfg, device="cpu"), from_jax_params(npp, device="cpu"))


def _seq_logprob(model, params, rows, t0):
    """Summed next-token log-prob of the generated span of ``rows``."""
    rows = torch.as_tensor(np.asarray(rows), dtype=torch.int64)
    toks = rows[:, :-1]
    pos = torch.arange(toks.shape[1]).expand_as(toks)
    with torch.no_grad():
        lp = torch.log_softmax(model.apply(params, toks, pos), dim=-1)
    picked = lp.gather(-1, rows[:, 1:, None])[..., 0]
    return picked[:, t0 - 1:].sum(dim=1).numpy()


@pytest.mark.parametrize("beam_size,eos_id,length_penalty",
                         [(3, None, 0.0), (4, 7, 0.7)],
                         ids=["k3", "k4-eos-lp"])
def test_beam_matches_reference(beam_size, eos_id, length_penalty):
    jm, jp, tm, tp = _pair(WINDOWED, 0)
    prompt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    want, wscores = jax_generate_beam(jm, jp, jnp.asarray(prompt), 9,
                                      beam_size=beam_size, eos_id=eos_id,
                                      length_penalty=length_penalty)
    got, scores = generate_beam(tm, tp, prompt, 9, beam_size=beam_size,
                                eos_id=eos_id, length_penalty=length_penalty)
    assert got.dtype == torch.int32 and scores.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(wscores), atol=1e-4)


@pytest.mark.parametrize("cfg", [CFG, dict(CFG, activation="gelu", attn_bias=True,
                                           tie_embeddings=True), WINDOWED],
                         ids=["relu", "gpt2", "windowed"])
def test_beam1_equals_greedy(cfg):
    """``beam_size=1`` reproduces greedy ``generate`` bit for bit, and its
    score is the sequence's summed log-prob (the reference's 1e-3)."""
    _, _, tm, tp = _pair(cfg, 0)
    prompt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    want = tm.generate(tp, prompt, 8)
    got, scores = generate_beam(tm, tp, prompt, 8, beam_size=1)
    assert torch.equal(got, want)
    np.testing.assert_allclose(scores.numpy(), _seq_logprob(tm, tp, want, 4),
                               atol=1e-3)
    wide, _ = generate_beam(tm, tp, prompt, 8, beam_size=4)
    assert tuple(wide.shape) == (2, 12)


def test_wide_beam_finds_exhaustive_optimum():
    """``beam_size = vocab`` with two new tokens is exhaustive."""
    _, _, tm, tp = _pair(dict(CFG, vocab=6, max_len=10), 3)
    prompt = np.array([[1, 2, 3]], np.int32)
    conts = np.array(list(itertools.product(range(6), repeat=2)), np.int32)
    rows = np.concatenate([np.repeat(prompt, len(conts), 0), conts], axis=1)
    lps = _seq_logprob(tm, tp, rows, 3)
    got, scores = generate_beam(tm, tp, prompt, 2, beam_size=6)
    np.testing.assert_array_equal(got.numpy(), rows[lps.argmax()][None])
    np.testing.assert_allclose(float(scores[0]), lps.max(), atol=1e-3)


def test_eos_freezes_beams():
    """With the best beam's second token as EOS, every position after a
    beam's first EOS stays EOS, and its score is the log-prob up to that
    EOS."""
    _, _, tm, tp = _pair(CFG, 2)
    prompt = np.array([[1, 2, 3, 4]], np.int32)
    free, _ = generate_beam(tm, tp, prompt, 12, beam_size=4)
    eos = int(free[0, 5])
    got, score = generate_beam(tm, tp, prompt, 12, beam_size=4, eos_id=eos)
    row = got[0, 4:].numpy()
    first = int(np.nonzero(row == eos)[0][0])
    assert (row[first:] == eos).all()
    span = got[:, :4 + first + 1].numpy()
    np.testing.assert_allclose(float(score[0]), _seq_logprob(tm, tp, span, 4)[0],
                               atol=1e-3)


def test_batch_rows_are_independent():
    _, _, tm, tp = _pair(CFG, 4)
    p1 = np.array([[1, 2, 3, 4]], np.int32)
    p2 = np.array([[8, 9, 10, 11]], np.int32)
    g_both, s_both = generate_beam(tm, tp, np.concatenate([p1, p2]), 6, beam_size=3)
    g1, s1 = generate_beam(tm, tp, p1, 6, beam_size=3)
    g2, s2 = generate_beam(tm, tp, p2, 6, beam_size=3)
    assert torch.equal(g_both, torch.cat([g1, g2]))
    np.testing.assert_allclose(s_both.numpy(), torch.cat([s1, s2]).numpy(), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(beam_size=0), dict(beam_size=200),
                                dict(n_new=400)], ids=["zero", "vocab", "max_len"])
def test_validation_matches_reference(kw):
    jm, jp, tm, tp = _pair(CFG, 0)
    prompt = np.array([[1, 2]], np.int32)
    kw = dict(dict(n_new=4), **kw)
    with pytest.raises(ValueError) as want:
        jax_generate_beam(jm, jp, prompt, **kw)
    with pytest.raises(ValueError) as got:
        generate_beam(tm, tp, prompt, **kw)
    assert str(got.value) == str(want.value)
    out, scores = generate_beam(tm, tp, prompt, 0)
    assert torch.equal(out, torch.as_tensor(prompt)) and scores.tolist() == [0.0]
