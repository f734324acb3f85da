"""The port's LoRA fine-tuning (``elephas_tpu_torch/models/lora.py``) on the
CPU: every test of the reference's ``tests/models/test_lora.py`` on the
port (the adapted model starts at the base, training moves only the
adapters and learns, merge, the weight-decay mask, save/load, the
full-state checkpoint, generation through adapters, validation), then
parity with the JAX package on the same numpy inputs: ``apply_lora``'s
``A`` draws bitwise, the adapted logits within 1e-5, an 8-step
``build_lora_lm_train_step`` loss trajectory (``optax.adam`` against the
port's ``adam``, dense and flash attention, GPT-2- and Llama-shaped)
within ``tests/test_torch_train.py``'s rtol 5e-3, and ``save_lora`` files
loading across the packages. The reference runs on a 1x1 ``build_mesh_sp``
with ``attn="dense"``."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elephas_tpu.models import lora as jl
from elephas_tpu.models import transformer as jt
from elephas_tpu_torch.models import (LoRATensor, MoETransformerLM,
                                      TransformerLM, adam, apply_lora,
                                      build_lora_lm_train_step, from_jax_params,
                                      load_lora, lora_mask, lora_trainable_count,
                                      make_lm_batches, masked, merge_lora,
                                      save_lora, to_numpy)
from elephas_tpu_torch.models.optimizers import MaskedState, _adam_family
from elephas_tpu_torch.utils import load_pytree, save_pytree

V = 13
BASE = dict(vocab=V, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=16)
CONFIGS = {
    "gpt2": dict(BASE, vocab=17, n_heads=4, max_len=48, activation="gelu",
                 attn_bias=True, pos_encoding="learned", tie_embeddings=True),
    "llama": dict(BASE, vocab=17, n_heads=4, max_len=48, activation="swiglu",
                  norm="rmsnorm", ffn_bias=False, pos_encoding="rotary",
                  n_kv_heads=2, rope_theta=500000.0),
}
LOSS_RTOL = 5e-3      # tests/test_torch_train.py's trajectory tolerance


def _model(**kw):
    return TransformerLM(**dict(BASE, **kw), device="cpu")


def _batch(rows=8, t=8, seed=0, vocab=V):
    rng = np.random.default_rng(seed)
    return make_lm_batches(rng.integers(0, vocab, size=(rows, t + 1)))


def _tokens(seed, t=8, vocab=V):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, vocab, size=(2, t)))
    return tokens, torch.arange(t).expand(2, t)


def _state_elems(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(_state_elems(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_state_elems(v) for v in tree)
    return int(np.size(tree))


def _train(model, lparams, steps, seed=0, lr=5e-2, **kw):
    step, opt_init = build_lora_lm_train_step(model, None, adam(lr),
                                              attn=kw.pop("attn", "dense"), **kw)
    state = opt_init(lparams)
    batch = _batch(seed=seed, vocab=model.vocab)
    losses = []
    for _ in range(steps):
        lparams, state, loss = step(lparams, state, *batch)
        losses.append(float(loss))
    return lparams, state, losses


# -- the reference's tests, on the port ------------------------------------


def test_adapted_model_starts_at_base():
    model = _model()
    base = model.init(1)
    lparams = apply_lora(base, rank=4)
    tokens, positions = _tokens(0)
    torch.testing.assert_close(model.apply(lparams, tokens, positions),
                               model.apply(base, tokens, positions),
                               rtol=0, atol=0)
    trainable, total = lora_trainable_count(lparams)
    assert 0 < trainable < 0.2 * total


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_training_moves_only_adapters_and_learns(attn):
    model = _model()
    lparams = apply_lora(model.init(1), rank=4)
    step, opt_init = build_lora_lm_train_step(model, None, adam(5e-2), attn=attn)
    state = opt_init(lparams)
    # the masked optimizer keeps moments for the adapter factors only
    trainable, _ = lora_trainable_count(lparams)
    assert isinstance(state, MaskedState)
    assert _state_elems(state) <= 2 * trainable + 16, (_state_elems(state), trainable)
    frozen = {k: (v.w if isinstance(v, LoRATensor) else v).clone()
              for k, v in lparams.items()}
    batch = _batch()
    losses = []
    for _ in range(8):
        lparams, state, loss = step(lparams, state, *batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for k, want in frozen.items():
        v = lparams[k]
        if isinstance(v, LoRATensor):
            torch.testing.assert_close(v.w, want, rtol=0, atol=0)
            assert v.b.abs().max() > 0         # the adapters moved
            assert v.a.grad is None and not v.a.requires_grad
        else:
            torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)


def test_merge_reproduces_adapted_model():
    """The merged dict reproduces the adapted model within 1e-5, and the
    merged weights quantize like any others (the reference's deployment
    composition): finite logits, equal to the dequantized weights' bit for
    bit; an unmerged dict is refused."""
    from elephas_tpu_torch.models import dequantize_params, quantize_lm_params

    model = _model()
    lparams, _, _ = _train(model, apply_lora(model.init(2), rank=4), 3, seed=3)
    merged = merge_lora(lparams)
    assert not any(isinstance(v, LoRATensor) for v in merged.values())
    tokens, positions = _tokens(4, t=10)
    torch.testing.assert_close(model.apply(merged, tokens, positions),
                               model.apply(lparams, tokens, positions),
                               rtol=1e-5, atol=1e-5)
    q = quantize_lm_params(merged)
    lq = model.apply(q, tokens, positions)
    assert torch.isfinite(lq).all()
    assert torch.equal(lq, model.apply(dequantize_params(q), tokens, positions))
    with pytest.raises(ValueError, match="merge_lora"):
        quantize_lm_params(lparams)


def test_lora_mask_protects_base_from_weight_decay():
    """``masked`` over ``lora_mask`` around AdamW (``_adam_family`` with a
    decay, optax.adamw's rule): zero gradients give every frozen leaf,
    each adapter's base included, an update of exactly 0, while the decay
    moves the adapters' nonzero ``a``."""
    model = _model()
    lparams = apply_lora(model.init(5), rank=2)
    mask = lora_mask(lparams)
    assert mask["wq"].tree_flatten()[0] == (False, True, True)
    assert mask["tok"] is False
    opt = masked(_adam_family(1e-2, 0.9, 0.999, 1e-8, weight_decay=0.5), mask)
    state = opt.init(lparams)
    zero = {k: (LoRATensor(torch.zeros_like(v.w), torch.zeros_like(v.a),
                           torch.zeros_like(v.b), v.alpha)
                if isinstance(v, LoRATensor) else torch.zeros_like(v))
            for k, v in lparams.items()}
    updates, _ = opt.update(zero, state, lparams)
    for k, v in lparams.items():
        u = updates[k]
        if isinstance(v, LoRATensor):
            assert torch.equal(u.w, torch.zeros_like(v.w))
            assert u.a.abs().max() > 0       # decayed: the mask lets it in
        else:
            assert torch.equal(u, torch.zeros_like(v)), k


def test_save_load_adapters_roundtrip(tmp_path):
    """Adapters persist alone (a small file) and reattach to a fresh base,
    reproducing the adapted model exactly."""
    model = _model()
    base = model.init(9)
    lparams, _, _ = _train(model, apply_lora(base, rank=4), 3, seed=11)
    path = str(tmp_path / "adapters.npz")
    save_lora(path, lparams)
    full_bytes = sum(v.numel() * v.element_size() for v in base.values())
    assert os.path.getsize(path) < 0.35 * full_bytes
    restored = load_lora(path, model.init(9))
    tokens, positions = _tokens(12)
    torch.testing.assert_close(model.apply(restored, tokens, positions),
                               model.apply(lparams, tokens, positions),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no LoRA adapters"):
        save_lora(str(tmp_path / "x.npz"), base)
    with pytest.raises(ValueError, match="no base param"):
        load_lora(path, {k: v for k, v in base.items() if k != "wq"})
    with pytest.raises(ValueError, match="does not fit base"):
        load_lora(path, _model(d_model=8, n_heads=2).init(0))


def test_full_state_checkpoint_of_adapted_params(tmp_path):
    """``save_pytree`` / ``load_pytree`` round-trip LoRATensor nodes (the
    full training-state form, beside the adapter-only ``save_lora``), the
    optimizer state with them."""
    model = _model()
    lparams, state, _ = _train(model, apply_lora(model.init(13), rank=2), 1)
    save_pytree(str(tmp_path / "state"), {"params": lparams, "opt": state})
    back = load_pytree(str(tmp_path / "state"))
    wq = back["params"]["wq"]
    assert isinstance(wq, LoRATensor) and wq.alpha == lparams["wq"].alpha
    for f in ("w", "a", "b"):
        torch.testing.assert_close(getattr(wq, f), getattr(lparams["wq"], f),
                                   rtol=0, atol=0)
    assert isinstance(back["opt"], MaskedState)
    torch.testing.assert_close(back["opt"].inner_state.mu["wq.b"],
                               state.inner_state.mu["wq.b"], rtol=0, atol=0)


def test_generate_works_through_adapters():
    model = _model()
    lparams = apply_lora(model.init(6), rank=2)
    prompt = np.array([[1, 2, 3]], np.int32)
    base_out = model.generate(model.init(6), prompt, n_new=6)
    assert torch.equal(model.generate(lparams, prompt, n_new=6), base_out)


def test_validation():
    model = _model()
    params = model.init(0)
    with pytest.raises(ValueError, match="not in params"):
        apply_lora(params, keys=("nope",))
    with pytest.raises(ValueError, match="non-matrix"):
        apply_lora(params, keys=("lnf_s",))
    l1 = apply_lora(params, rank=2)
    assert apply_lora(l1, rank=2)["wq"] is l1["wq"]   # idempotent
    with pytest.raises(ValueError, match="already adapted"):
        apply_lora(l1, rank=8)
    moe = MoETransformerLM(vocab=V, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                           max_len=16, n_experts=2, k=1, device="cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        build_lora_lm_train_step(moe, None, adam(1e-2))
    for attn in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="item 6|Parallel"):
            build_lora_lm_train_step(model, None, adam(1e-2), attn=attn)
    with pytest.raises(NotImplementedError, match="mesh"):
        build_lora_lm_train_step(model, object(), adam(1e-2), attn="dense")
    step, opt_init = build_lora_lm_train_step(model, None, adam(1e-2), attn="dense")
    with pytest.raises(ValueError, match="exceeds max_len"):
        step(l1, opt_init(l1), *_batch(rows=2, t=BASE["max_len"] + 1))


# -- the port's own pins ------------------------------------------------------


def test_layer_views_stay_lazy():
    """A layer index, ``unbind(0)`` and a leading reshape give nodes (one
    layer materializes at a time); ``.to(dtype)`` and ``@`` materialize
    ``w + (alpha/r) a@b``; ``.to(device)`` moves the parts."""
    model = _model()
    node = apply_lora(model.init(0), rank=4)["wq"]
    node.b = torch.randn(node.b.shape, generator=torch.Generator().manual_seed(0))
    want = node.w + (node.alpha / 4) * node.a @ node.b
    layer = node[1]
    assert isinstance(layer, LoRATensor) and layer.shape == node.shape[1:]
    parts = node.unbind(0)
    assert all(isinstance(p, LoRATensor) for p in parts) and len(parts) == 2
    assert isinstance(node.reshape(2, 1, 16, 16), LoRATensor)
    assert isinstance(node.to("cpu"), LoRATensor)
    torch.testing.assert_close(layer.to(torch.float32), want[1], rtol=1e-6, atol=1e-6)
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(x @ parts[0], x @ want[0], rtol=1e-5, atol=1e-6)
    assert layer.to(torch.bfloat16).dtype == torch.bfloat16
    lparams = apply_lora(model.init(0), rank=4)
    assert isinstance(model._layer(lparams, 0)["wq"], LoRATensor)
    assert all(isinstance(lp["wv"], LoRATensor) for lp in model._layers(lparams))


def test_vocab_block_step_matches_dense_head():
    """``vocab_block`` streams the head (an adapted untied head
    materializes): the same losses as the full head within 1e-5."""
    model = _model(vocab=17)
    start = apply_lora(model.init(3), keys=("wq", "wv", "head"), rank=4)
    _, _, full = _train(model, start, 3)
    _, _, streamed = _train(model, start, 3, vocab_block=5)
    np.testing.assert_allclose(streamed, full, rtol=1e-5, atol=1e-6)


# -- parity with the JAX package -------------------------------------------


def _jax_lora(np_params, rank, seed=0, b_seed=None):
    """The reference's adapted params (``b`` random when ``b_seed`` is set,
    so the delta is nonzero)."""
    lp = jl.apply_lora({k: jnp.asarray(v) for k, v in np_params.items()},
                       rank=rank, seed=seed)
    if b_seed is None:
        return lp
    rng = np.random.default_rng(b_seed)
    return {k: (jl.LoRATensor(v.w, v.a, jnp.asarray(
                    rng.normal(size=v.b.shape).astype(np.float32) * 0.1), v.alpha)
                if isinstance(v, jl.LoRATensor) else v)
            for k, v in lp.items()}


def test_apply_lora_draws_the_reference_bits():
    np_params = jt.TransformerLM(**BASE).init(3)
    want = jl.apply_lora({k: jnp.asarray(v) for k, v in np_params.items()},
                         keys=("wq", "wk", "wv"), rank=4, seed=5)
    got = apply_lora(from_jax_params(np_params, device="cpu"),
                     keys=("wq", "wk", "wv"), rank=4, seed=5)
    for k in ("wq", "wk", "wv"):
        np.testing.assert_array_equal(got[k].a.numpy(), np.asarray(want[k].a))
        assert not got[k].b.any() and got[k].alpha == want[k].alpha


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_adapted_logits_match_reference(name):
    """The reference's LoRA nodes cross through ``from_jax_params`` (and
    back through ``to_numpy``); the adapted logits agree within 1e-5."""
    jm = jt.TransformerLM(**CONFIGS[name])
    np_params = jm.init(1)
    jlp = _jax_lora(np_params, rank=4, b_seed=2)
    params = from_jax_params(jlp, device="cpu")
    assert isinstance(params["wq"], LoRATensor)
    model = TransformerLM(**CONFIGS[name], device="cpu")
    tokens, positions = _tokens(7, t=12, vocab=17)
    want = np.asarray(jm.apply(jlp, jnp.asarray(tokens.numpy(), jnp.int32),
                               jnp.asarray(positions.numpy(), jnp.int32),
                               attn="dense"))
    got = model.apply(params, tokens, positions).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = to_numpy(params)
    np.testing.assert_array_equal(back["wv"].b, np.asarray(jlp["wv"].b))
    assert back["wv"].alpha == jlp["wv"].alpha


@pytest.mark.parametrize("name,attn", [("gpt2", "dense"), ("llama", "flash")])
def test_train_trajectory_matches_reference(name, attn):
    """8 steps of ``build_lora_lm_train_step`` from the same weights and
    factors on the same tokens: the port's ``adam`` against ``optax.adam``
    (the reference on a 1x1 mesh, dense attention), rtol 5e-3."""
    jm = jt.TransformerLM(**CONFIGS[name])
    np_params = jm.init(4)
    batch = _batch(rows=4, t=16, seed=5, vocab=17)
    mesh = jt.build_mesh_sp(data=1, seq=1)
    jstep, jinit = jl.build_lora_lm_train_step(jm, mesh, optax.adam(1e-2),
                                               attn="dense")
    jlp = _jax_lora(np_params, rank=4, seed=6)
    jstate = jinit(jlp)
    jbatch = jt.shard_lm_batch(mesh, *batch)
    want = []
    for _ in range(8):
        jlp, jstate, loss = jstep(jlp, jstate, *jbatch)
        want.append(float(loss))
    model = TransformerLM(**CONFIGS[name], device="cpu")
    lparams = apply_lora(from_jax_params(np_params, device="cpu"), rank=4, seed=6)
    step, opt_init = build_lora_lm_train_step(model, None, adam(1e-2), attn=attn)
    state = opt_init(lparams)
    got = []
    for _ in range(8):
        lparams, state, loss = step(lparams, state, *batch)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-5)
    assert got[-1] < got[0]


def test_save_lora_files_cross_packages(tmp_path):
    """A port file loads into the JAX package and a JAX file into the port,
    each reproducing the writer's adapted logits within 1e-5."""
    jm = jt.TransformerLM(**BASE)
    np_params = jm.init(8)
    jlp = _jax_lora(np_params, rank=4, b_seed=9)
    model = _model()
    tokens, positions = _tokens(10)
    jt_tok = jnp.asarray(tokens.numpy(), jnp.int32)
    jt_pos = jnp.asarray(positions.numpy(), jnp.int32)
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    jl.save_lora(jax_file, jlp)
    got = model.apply(load_lora(jax_file, from_jax_params(np_params, device="cpu")),
                      tokens, positions).numpy()
    want = np.asarray(jm.apply(jlp, jt_tok, jt_pos, attn="dense"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plp = from_jax_params(jlp, device="cpu")
    save_lora(port_file, plp)
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)
    jback = jl.load_lora(port_file, {k: jnp.asarray(v) for k, v in np_params.items()})
    np.testing.assert_allclose(np.asarray(jm.apply(jback, jt_tok, jt_pos, attn="dense")),
                               model.apply(plp, tokens, positions).numpy(),
                               rtol=1e-5, atol=1e-5)
