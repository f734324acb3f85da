"""``build_lm_train_phases`` in the port against the JAX package's on a
1x1 CPU mesh, from the same weights and tokens: the forward's loss, the
forward-and-backward's loss and gradients, the reduction (the identity on
one device), and the optimizer phase's new params from the same
gradients; within the port, ``apply(params, state, grad(...)[1])`` is the
step's update bit for bit, for each knob the phases share with the step.
Tolerances: losses rtol 1e-5, gradients and params 1e-4 of scale (float32
sums in another framework)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import adam_compact as jax_adam_compact
from elephas_tpu.models import transformer as jt
from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                      build_lm_train_phases, build_lm_train_step,
                                      from_jax_params, make_lm_batches)

V = 17
BASE = dict(vocab=V, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
CONFIGS = {
    "gpt2": dict(BASE, activation="gelu", norm="layernorm", attn_bias=True,
                 ffn_bias=True, pos_encoding="learned", tie_embeddings=True),
    "mistral": dict(BASE, activation="swiglu", norm="rmsnorm", attn_bias=False,
                    ffn_bias=False, pos_encoding="rotary", n_kv_heads=2,
                    attn_window=(6, None)),
}
LR = 1e-2


def _setup(name, seed=0):
    jm = jt.TransformerLM(**CONFIGS[name])
    npp = jm.init(seed)
    rows = np.random.default_rng(seed).integers(0, V, size=(4, 25))
    return jm, npp, TransformerLM(**CONFIGS[name], device="cpu"), make_lm_batches(rows)


def _close(got, want, what, floor=0.0):
    """Within 1e-4 of the tensor's scale, floored at ``floor``: GPT-2's key
    bias has an exact gradient of zero (softmax ignores a shift of a
    query's scores), so its entries are rounding noise in both."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), floor),
                               err_msg=what)


@pytest.mark.parametrize("name,attn", [("gpt2", "flash"), ("mistral", "dense")])
def test_phases_match_reference(name, attn):
    jm, npp, tm, batch = _setup(name)
    mesh = jt.build_mesh_sp(data=1, seq=1)
    jph = jt.build_lm_train_phases(jm, mesh, jax_adam_compact(LR), attn=attn)
    jp = jm.shard_params(mesh, {k: jnp.asarray(v) for k, v in npp.items()})
    jbatch = jt.shard_lm_batch(mesh, *batch)
    ph = build_lm_train_phases(tm, None, adam_compact(LR), attn=attn)
    tp = from_jax_params(npp, device="cpu")

    np.testing.assert_allclose(float(ph["loss"](tp, *batch)),
                               float(jph["loss"](jp, *jbatch)), rtol=1e-5)
    loss, grads = ph["grad"](tp, *batch)
    jloss, jgrads = jph["grad"](jp, *jbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    floor = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    for k in jgrads:
        _close(grads[k], jgrads[k], k, 1e-3 * floor)
    assert ph["reduce"](grads) is grads
    # the optimizer phase on the same gradients in both (Adam turns the
    # noise of a zero gradient into whole steps)
    same = jph["reduce"]({k: jnp.asarray(g.numpy()) for k, g in grads.items()})
    new, _ = ph["apply"](tp, adam_compact(LR).init(tp), grads)
    jnew, _ = jph["apply"](jp, jax_adam_compact(LR).init(jp), same)
    for k in jnew:
        _close(new[k], jnew[k], k)


@pytest.mark.parametrize("knobs", [{}, dict(fused_apply=True), dict(accum_steps=2),
                                   dict(vocab_block=8), dict(remat="dots")],
                         ids=["plain", "fused_apply", "accum2", "vocab_block", "remat"])
def test_apply_of_grad_is_the_step(knobs):
    """The phases share the step's pieces: the loss phase is the step's
    loss, ``apply(params, state, grad(...)[1])`` its new params and state
    bit for bit, and no phase touches its arguments."""
    _, npp, tm, batch = _setup("mistral", seed=1)
    params = from_jax_params(npp, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    opt = adam_compact(LR)
    ph = build_lm_train_phases(tm, None, opt, attn="flash", **knobs)
    step, opt_init = build_lm_train_step(tm, None, opt, attn="flash", **knobs)
    state = opt_init(params)
    want_p, want_s, want_loss = step(params, state, *batch)
    loss, grads = ph["grad"](params, *batch)
    got_p, got_s = ph["apply"](params, state, ph["reduce"](grads))
    assert torch.equal(loss, want_loss)
    torch.testing.assert_close(ph["loss"](params, *batch), want_loss,
                               rtol=1e-6, atol=0)
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k
        assert torch.equal(params[k], before[k]), k
    for a, b in zip(jax.tree_util.tree_leaves(got_s), jax.tree_util.tree_leaves(want_s)):
        assert torch.equal(a, b)


def test_phases_validate_as_the_step():
    _, _, tm, _ = _setup("gpt2")
    opt = adam_compact(LR)
    with pytest.raises(NotImplementedError, match="mesh"):
        build_lm_train_phases(tm, object(), opt, attn="flash")
    with pytest.raises(NotImplementedError, match="item 6"):
        build_lm_train_phases(tm, None, opt, attn="flash", overlap_grads=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        build_lm_train_step(tm, None, opt, attn="flash", overlap_grads=True)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        build_lm_train_phases(tm, None, opt)       # attn="ring", the default
    with pytest.raises(ValueError, match="remat"):
        build_lm_train_phases(tm, None, opt, attn="flash", remat="some")
    with pytest.raises(ValueError, match="accum_steps"):
        build_lm_train_phases(tm, None, opt, attn="flash", accum_steps=0)
    assert set(build_lm_train_phases(tm, None, opt, attn="dense")) == \
        {"loss", "grad", "reduce", "apply"}
