"""Weight-only int8 quantization (``elephas_tpu_torch/models/quantize.py``)
against the JAX package's ``models/quantize.py``.

- ``q`` and ``s`` equal the reference's bit for bit for the same weights
  (both packages draw the same init from a seed), dense and MoE stacks, the
  tied and untied heads.
- The load-bearing property, pinned within the port: every use site
  dequantizes to IDENTICAL float values, so the model on quantized params
  equals the model on the eagerly dequantized params bit for bit: logits,
  ``generate``, speculative decoding, and the serving engine dense and
  paged.
- The port's quantized logits against the reference's quantized logits at
  the LM parity pin (atol/rtol 1e-4, ``tests/test_torch_transformer.py``),
  and the reference's own accuracy criterion against the float model.
- The reference's remaining pins: the rounding error bound, the storage
  size, idempotence and the refusal of an unmerged ``LoRATensor``.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import quantize as jq
from elephas_tpu.models import transformer as jt
from elephas_tpu_torch.models import (LoRATensor, MoETransformerLM, QuantizedTensor,
                                      TransformerLM, dequantize_params,
                                      quantize_lm_params, quantized_nbytes)
from elephas_tpu_torch.serving import ServingEngine

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32)
MOE = dict(vocab=32, d_model=16, n_heads=4, n_layers=1, d_ff=32, max_len=16,
           n_experts=4, k=1)
CONFIGS = {"base": {}, "rotary_gqa": {"pos_encoding": "rotary", "n_kv_heads": 2},
           "tied": {"tie_embeddings": True}}


def _pair(kw, seed):
    """``(port model, port params, reference model, reference params)`` of
    one configuration, the same weights in both."""
    cfg = {**BASE, **kw}
    model = TransformerLM(**cfg, device="cpu")
    jmodel = jt.TransformerLM(**cfg)
    return (model, model.init(seed), jmodel,
            {k: jnp.asarray(v) for k, v in jmodel.init(seed=seed).items()})


def _tokens(seed, n=2, t=10, vocab=64):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(n, t)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t), (n, t))
    return toks, pos


def _assert_same_quantization(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, jq.QuantizedTensor):
            assert isinstance(g, QuantizedTensor), name
            assert g.row_scaled == w.row_scaled, name
            assert g.q.dtype == torch.int8 and g.s.dtype == torch.float32, name
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), err_msg=name)
            np.testing.assert_array_equal(g.s.numpy(), np.asarray(w.s), err_msg=name)
        else:
            assert not isinstance(g, QuantizedTensor), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantization_matches_reference_bitwise(name):
    _, params, _, jparams = _pair(CONFIGS[name], seed=1)
    _assert_same_quantization(quantize_lm_params(params), jq.quantize_lm_params(jparams))


def test_roundtrip_error_bounded_and_size_shrinks():
    model, params, _, _ = _pair({}, seed=0)
    qparams = quantize_lm_params(params)
    for name in ("wq", "wo", "w1", "tok"):
        orig = params[name].numpy()
        deq = qparams[name].dequantize().numpy()
        reduce_axis = -2 if name != "tok" else -1
        scale = np.max(np.abs(orig), axis=reduce_axis, keepdims=True) / 127.0
        assert np.all(np.abs(orig - deq) <= scale / 2 + 1e-7), name
    assert not isinstance(qparams["ln1_s"], QuantizedTensor)
    assert qparams["ln1_s"] is params["ln1_s"]
    orig_bytes = sum(v.nbytes for v in params.values())
    assert quantized_nbytes(qparams) < 0.45 * orig_bytes


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantized_equals_dequantized_exactly(name):
    """apply / generate on quantized params == on the dequantized params,
    bit for bit, and the logits match the reference's quantized model."""
    model, params, jmodel, jparams = _pair(CONFIGS[name], seed=1)
    qparams = quantize_lm_params(params)
    dparams = dequantize_params(qparams)
    toks, pos = _tokens(0)
    tt, tp = torch.as_tensor(toks), torch.as_tensor(pos)
    lq = model.apply(qparams, tt, tp, attn="dense")
    torch.testing.assert_close(lq, model.apply(dparams, tt, tp, attn="dense"),
                               rtol=0, atol=0)
    gq = model.generate(qparams, tt[:, :4], n_new=8)
    torch.testing.assert_close(gq, model.generate(dparams, tt[:, :4], n_new=8),
                               rtol=0, atol=0)
    jl = jmodel.apply(jq.quantize_lm_params(jparams), jnp.asarray(toks), pos, attn="dense")
    np.testing.assert_allclose(lq.numpy(), np.asarray(jl), **TOL)


def test_quantized_logits_close_to_float():
    model, params, _, _ = _pair({}, seed=2)
    qparams = quantize_lm_params(params)
    toks, pos = _tokens(1, t=12)
    tt, tp = torch.as_tensor(toks), torch.as_tensor(pos)
    lf = model.apply(params, tt, tp, attn="dense").numpy()
    lq = model.apply(qparams, tt, tp, attn="dense").numpy()
    assert np.abs(lf - lq).max() < 0.15 * np.abs(lf).max()
    agree = (lf.argmax(-1) == lq.argmax(-1)).mean()
    assert agree > 0.9, agree


def test_quantize_is_idempotent():
    model, params, _, _ = _pair({}, seed=0)
    q1 = quantize_lm_params(params)
    q2 = quantize_lm_params(q1)
    for k, v in q1.items():
        assert q2[k] is v, k


def test_unmerged_lora_rejected_with_clear_error():
    _, params, _, _ = _pair({}, seed=0)
    w = params["wq"]
    params["wq"] = LoRATensor(w, torch.zeros(*w.shape[:2], 2), torch.zeros(w.shape[0], 2,
                                                                            w.shape[2]),
                              alpha=4.0)
    with pytest.raises(ValueError, match="merge_lora"):
        quantize_lm_params(params)


def test_layer_views_stay_quantized():
    """A layer index, ``unbind(0)`` and a leading-dim reshape keep ``q`` and
    ``s`` (one layer dequantizes at a time); the embedding gathers before
    it scales; every view dequantizes to the full tensor's values."""
    _, params, _, _ = _pair({"tie_embeddings": True}, seed=3)
    q = quantize_lm_params(params)
    full = q["wq"].dequantize()
    layer = q["wq"][1]
    assert isinstance(layer, QuantizedTensor) and tuple(layer.shape) == tuple(full.shape[1:])
    torch.testing.assert_close(layer.to(torch.float32), full[1], rtol=0, atol=0)
    views = q["w1"].unbind(0)
    assert all(isinstance(v, QuantizedTensor) for v in views)
    torch.testing.assert_close(torch.stack([v.dequantize() for v in views]),
                               q["w1"].dequantize(), rtol=0, atol=0)
    regrouped = q["wq"].reshape(2, 1, *full.shape[1:])
    assert isinstance(regrouped, QuantizedTensor)
    torch.testing.assert_close(regrouped.dequantize(), full.reshape(2, 1, *full.shape[1:]),
                               rtol=0, atol=0)
    ids = torch.tensor([[3, 5], [63, 0]])
    torch.testing.assert_close(q["tok"][ids], q["tok"].dequantize()[ids], rtol=0, atol=0)
    torch.testing.assert_close(q["tok"].T, q["tok"].dequantize().T, rtol=0, atol=0)
    h = torch.randn(2, 32, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(h @ q["wo"][0], h @ q["wo"].dequantize()[0], rtol=0, atol=0)
    assert q["tok"].device == torch.device("cpu") and q["wq"].ndim == 3


def test_moe_expert_stacks_quantize_and_stay_exact():
    """MoE w1/w2 are [L, E, in, out]: quantized per (layer, expert,
    channel), the reference's bits; apply on quantized params == on
    dequantized params, and matches the reference's quantized MoE."""
    moe = MoETransformerLM(**MOE, device="cpu")
    jmoe = jt.MoETransformerLM(**MOE)
    params = moe.init(5)
    qparams = quantize_lm_params(params)
    jq_params = jq.quantize_lm_params({k: jnp.asarray(v)
                                       for k, v in jmoe.init(seed=5).items()})
    _assert_same_quantization(qparams, jq_params)
    assert isinstance(qparams["w1"], QuantizedTensor)
    assert tuple(qparams["w1"].s.shape) == (1, 4, 1, 32)
    dparams = dequantize_params(qparams)
    toks, pos = _tokens(2, t=8, vocab=32)
    tt, tp = torch.as_tensor(toks), torch.as_tensor(pos)
    lq = moe.apply(qparams, tt, tp, attn="dense")
    torch.testing.assert_close(lq, moe.apply(dparams, tt, tp, attn="dense"), rtol=0, atol=0)
    jl = jmoe.apply(jq_params, jnp.asarray(toks), pos, attn="dense")
    np.testing.assert_allclose(lq.numpy(), np.asarray(jl), **TOL)


def test_quantized_speculative_decoding_runs():
    """Quantized target + quantized draft through the speculative path:
    exactly the quantized target's own greedy rollout."""
    target = TransformerLM(**BASE, device="cpu")
    t_q = quantize_lm_params(target.init(3))
    draft = TransformerLM(**{**BASE, "d_model": 16, "n_heads": 2, "n_layers": 1,
                             "d_ff": 32}, device="cpu")
    d_q = quantize_lm_params(draft.init(4))
    prompt = torch.tensor([[1, 2, 3]])
    want = target.generate(t_q, prompt, n_new=8)
    got = target.generate_speculative(t_q, prompt, n_new=8, draft=draft,
                                      draft_params=d_q, spec_k=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_quantized_serving_equals_dequantized(paged):
    """The serving engine on quantized params streams the dequantized
    params' tokens bit for bit (greedy and sampled), dense and paged, MoE
    included."""
    for model in (TransformerLM(**{**BASE, "pos_encoding": "rotary", "n_kv_heads": 2},
                                device="cpu"),
                  MoETransformerLM(**{**MOE, "max_len": 32}, moe_dispatch="gmm",
                                   device="cpu")):
        q = quantize_lm_params(model.init(7))
        streams = []
        for params in (q, dequantize_params(q)):
            eng = ServingEngine(model, params, n_slots=2, device="cpu",
                                **(dict(paged=True, page_size=8) if paged else {}))
            rng = np.random.default_rng(1)
            ids = [eng.submit(rng.integers(0, model.vocab, size=n).tolist(), 6,
                              temperature=t, seed=5)
                   for n, t in ((5, 0.0), (9, 0.8), (3, 0.0))]
            done = eng.drain()
            streams.append([list(done[i].tokens) for i in ids])
        assert streams[0] == streams[1]
