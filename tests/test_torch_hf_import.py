"""Hugging Face checkpoint import (``elephas_tpu_torch/models/hf_import.py``)
against the JAX package's ``models/hf_import.py`` and the Hugging Face
models themselves.

Tiny, randomly initialised ``transformers`` models built from local configs
(GPT-2, Llama with GQA, biases, tied heads and another theta, Mistral with a
binding window, Qwen2 with mixed per-layer windows, Mixtral with top-2 and
top-1 routing) go to both packages: the port's params equal the
reference's bit for bit (names, shapes, values), the architecture knobs
match, and the port's logits and greedy tokens match the Hugging Face
forward pass and ``generate`` at the reference's pins (rtol = atol = 2e-4,
tokens exactly). Nothing is downloaded: ``load_hf_lm`` reads a checkpoint
saved to a temporary directory. The reference's two sharded tests
(expert-parallel and tensor-parallel generation) wait for the sharding
slice.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import types

import numpy as np
import pytest
import torch
import transformers

from elephas_tpu.models.hf_import import lm_from_hf as j_lm_from_hf
from elephas_tpu_torch.models import lm_from_hf, load_hf_lm, quantize_lm_params


def _hf_logits(hf_model, tokens):
    with torch.no_grad():
        return hf_model(input_ids=torch.tensor(tokens, dtype=torch.long)).logits.float().numpy()


def _params(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def _our_logits(model, params, tokens):
    pos = torch.arange(tokens.shape[1]).expand(tokens.shape)
    with torch.no_grad():
        return model.apply(_params(params), torch.as_tensor(tokens), pos).numpy()


def _convert_both(hf):
    """The port's import of ``hf``, checked against the reference's: the
    same param names, shapes and bits, and the same architecture."""
    model, params = lm_from_hf(hf, device="cpu")
    jmodel, jparams = j_lm_from_hf(hf)
    assert list(params) == list(jparams)
    for k, v in jparams.items():
        assert params[k].dtype == np.float32, k
        np.testing.assert_array_equal(params[k], np.asarray(v), err_msg=k)
    for knob in ("vocab", "d_model", "n_heads", "n_kv_heads", "n_layers", "d_ff",
                 "max_len", "pos_encoding", "tie_embeddings", "activation", "norm",
                 "norm_eps", "attn_bias", "ffn_bias", "rope_theta", "attn_windows"):
        assert getattr(model, knob) == getattr(jmodel, knob), knob
    assert model.compute_dtype == torch.float32
    assert model.device == torch.device("cpu")
    return model, params


def _assert_logits_close(model, params, hf_model, tokens):
    np.testing.assert_allclose(_our_logits(model, params, tokens),
                               _hf_logits(hf_model, tokens), rtol=2e-4, atol=2e-4)


def _assert_greedy_parity(model, params, hf_model, tokens, n_new=6):
    with torch.no_grad():
        hf_out = hf_model.generate(
            torch.tensor(tokens, dtype=torch.long), max_new_tokens=n_new,
            attention_mask=torch.ones(tokens.shape, dtype=torch.long),
            do_sample=False, eos_token_id=None, pad_token_id=0,
        ).numpy()
        ours = model.generate(_params(params), torch.as_tensor(tokens), n_new).numpy()
    np.testing.assert_array_equal(ours, hf_out)


def _tiny_gpt2():
    torch.manual_seed(7)
    cfg = transformers.GPT2Config(
        vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0,
    )
    return transformers.GPT2LMHeadModel(cfg).eval()


def _tiny_llama(**over):
    torch.manual_seed(7)
    kw = dict(
        vocab_size=97, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, rope_theta=10000.0,
        attention_dropout=0.0, tie_word_embeddings=False,
    )
    kw.update(over)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(**kw)).eval()


def _tiny_mistral(**over):
    torch.manual_seed(7)
    kw = dict(
        vocab_size=97, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, sliding_window=8, attention_dropout=0.0,
        attn_implementation="eager",
    )
    kw.update(over)
    return transformers.MistralForCausalLM(transformers.MistralConfig(**kw)).eval()


def _tiny_qwen2(**over):
    torch.manual_seed(7)
    kw = dict(
        vocab_size=97, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, attention_dropout=0.0,
        attn_implementation="eager",
    )
    kw.update(over)
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**kw)).eval()


def _tiny_mixtral(**over):
    torch.manual_seed(7)
    kw = dict(
        vocab_size=97, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, num_local_experts=4,
        num_experts_per_tok=2, attention_dropout=0.0, sliding_window=None,
        attn_implementation="eager",
    )
    kw.update(over)
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(**kw)).eval()


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, 97, size=(2, 12)).astype(np.int32)


def _long_tokens(seed=0, t=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 97, size=(2, t)).astype(np.int32)


def test_gpt2_logits_and_greedy_parity(tokens):
    hf = _tiny_gpt2()
    model, params = _convert_both(hf)
    assert model.activation == "gelu" and model.attn_bias
    assert model.tie_embeddings and model.pos_encoding == "learned"
    _assert_logits_close(model, params, hf, tokens)
    _assert_greedy_parity(model, params, hf, tokens)


@pytest.mark.parametrize("over", [
    {},
    {"num_key_value_heads": 2},
    {"attention_bias": True},
    {"tie_word_embeddings": True, "rope_theta": 500000.0},
], ids=["plain", "gqa", "bias", "tied_theta"])
def test_llama_logits_parity(over, tokens):
    hf = _tiny_llama(**over)
    model, params = _convert_both(hf)
    assert model.activation == "swiglu" and model.norm == "rmsnorm"
    assert not model.ffn_bias and model.pos_encoding == "rotary"
    assert model.n_kv_heads == over.get("num_key_value_heads", 4)
    assert model.attn_bias == over.get("attention_bias", False)
    assert model.tie_embeddings == over.get("tie_word_embeddings", False)
    _assert_logits_close(model, params, hf, tokens)


def test_llama_greedy_generation_parity(tokens):
    hf = _tiny_llama(num_key_value_heads=2)
    model, params = _convert_both(hf)
    _assert_greedy_parity(model, params, hf, tokens)


def test_imported_model_int8_quantize_still_generates(tokens):
    hf = _tiny_llama()
    model, params = lm_from_hf(hf, device="cpu")
    qp = quantize_lm_params(_params(params))
    out = model.generate(qp, torch.as_tensor(tokens), 4)
    assert tuple(out.shape) == (tokens.shape[0], tokens.shape[1] + 4)


def test_unsupported_model_type_and_rope_scaling_raise():
    hf = _tiny_gpt2()
    hf.config.model_type = "bloom"
    with pytest.raises(NotImplementedError, match="model_type"):
        lm_from_hf(hf, device="cpu")
    hf = _tiny_llama()
    hf.config.rope_scaling = {"rope_type": "linear", "factor": 2.0}
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        lm_from_hf(hf, device="cpu")


def test_mistral_sliding_window_parity():
    """The window binds (T 24 > window 8): logits against torch's own
    sliding-window mask, and greedy tokens; a window past ``max_len``
    drops the knob."""
    hf = _tiny_mistral()
    model, params = _convert_both(hf)
    assert model.attn_window == 8 and model.max_len == 64
    _assert_logits_close(model, params, hf, _long_tokens())
    _assert_greedy_parity(model, params, hf, _long_tokens(t=12))
    model, _ = _convert_both(_tiny_mistral(sliding_window=64))
    assert model.attn_window is None


def test_qwen2_mixed_sliding_layers_import_parity():
    """Qwen2 with ``max_window_layers`` windows only some layers: a
    per-layer window list; logits with the window binding and greedy tokens
    past the window."""
    hf = _tiny_qwen2(use_sliding_window=True, sliding_window=8, max_window_layers=1)
    model, params = _convert_both(hf)
    assert model.mixed_window
    assert model.attn_windows == (None, 8)
    _assert_logits_close(model, params, hf, _long_tokens())
    hf = _tiny_qwen2(use_sliding_window=True, sliding_window=6, max_window_layers=1)
    model, params = _convert_both(hf)
    _assert_greedy_parity(model, params, hf, _long_tokens(seed=1, t=9), n_new=8)


def test_qwen2_default_no_sliding_imports_full_attention(tokens):
    hf = _tiny_qwen2()
    model, params = _convert_both(hf)
    assert model.attn_window is None and model.attn_bias
    _assert_logits_close(model, params, hf, tokens)


@pytest.mark.parametrize("k", [2, 1], ids=["top2", "top1"])
def test_mixtral_logits_and_greedy_parity(k, tokens):
    hf = _tiny_mixtral(num_experts_per_tok=k)
    model, params = _convert_both(hf)
    assert type(model).__name__ == "MoETransformerLM"
    assert model.moe.activation == "swiglu" and not model.moe.bias
    assert model.moe.capacity_factor * model.moe.k == model.n_experts
    _assert_logits_close(model, params, hf, tokens)
    if k == 2:
        _assert_greedy_parity(model, params, hf, tokens)


def test_duck_typed_model_and_local_checkpoint(tmp_path, tokens):
    """Any object with ``.config`` and ``.state_dict()`` converts (what the
    card, which has no ``transformers``, hands the import), and
    ``load_hf_lm`` reads a checkpoint saved to a local directory: both give
    the live model's params; ``compute_dtype`` becomes the torch dtype."""
    hf = _tiny_gpt2()
    _, want = lm_from_hf(hf, device="cpu")
    duck = types.SimpleNamespace(config=types.SimpleNamespace(**hf.config.to_dict()),
                                 state_dict=lambda: dict(hf.state_dict()))
    model, got = lm_from_hf(duck, compute_dtype="bfloat16", device="cpu")
    assert model.compute_dtype == torch.bfloat16
    hf.save_pretrained(tmp_path)
    _, loaded = load_hf_lm(str(tmp_path), device="cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
