"""The port's rope-fused flash attention (``flash_attention_rope``: q and k
arrive unrotated and the kernels rotate them on load; on the CPU its plain
versions) against the JAX package's Pallas ``flash_attention_rope`` in
interpret mode and against rotate-then-attend in both packages, forward and
gradients, on the same numpy inputs, at the reference's own tolerances
(``tests/ops/test_pallas_flash.py``: 2e-5; ``tests/ops/
test_window_attention.py``: 1e-4 with a window). Then the model's routing
(a rotary model on ``attn="flash"`` trains through the fused entry and
``prefill`` does not), and the reference-shaped positional calls of every
repaired signature and of ``flash_attention_tpu``, the reference's Pallas
entry, in both packages."""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elephas_tpu
import elephas_tpu_torch
from elephas_tpu.models import transformer as jt
from elephas_tpu.ops import attention_reference as jax_attention_reference
from elephas_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from elephas_tpu.ops.pallas_flash import \
    flash_attention_rope as jax_flash_attention_rope
from elephas_tpu.ops.pallas_flash import \
    flash_attention_tpu as jax_flash_attention_tpu
from elephas_tpu.ops.pallas_flash import \
    flash_attention_with_lse as jax_flash_attention_with_lse
from elephas_tpu.ops.pallas_flash import make_rope_tables as jax_make_rope_tables
from elephas_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                      build_lm_train_step, from_jax_params,
                                      make_lm_batches)
from elephas_tpu_torch.models import transformer as pt
from elephas_tpu_torch.ops import (attention_reference, flash_attention,
                                   flash_attention_rope, flash_attention_with_lse,
                                   flash_decode, make_rope_tables)
from elephas_tpu_torch.ops.flash_attention import flash_attention_tpu
from elephas_tpu_torch.parallel import build_mesh

jax_fd = importlib.import_module("elephas_tpu.ops.flash_decode")
port_fd = importlib.import_module("elephas_tpu_torch.ops.flash_decode")

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(rng, b, t, h, hkv, dh):
    return (rng.normal(size=(b, t, h, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, t, h, dh)).astype(np.float32))


def _angles(b, t, dh, theta=10000.0, offset=0):
    """The reference's ``(cos, sin)`` ``[B, T, Dh/2]`` as numpy."""
    positions = jnp.broadcast_to(jnp.arange(offset, offset + t), (b, t))
    cos, sin = jt._rope_angles(positions, dh, theta)
    return np.asarray(cos), np.asarray(sin)


def _port_vjp(fn, q, k, v, g):
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*args)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), args)
    return out.detach().numpy(), [a.numpy() for a in grads]


def _port_rope(q, k, v, g, cos, sin, window=None):
    c2, s2 = make_rope_tables(torch.from_numpy(cos), torch.from_numpy(sin))
    return _port_vjp(lambda q, k, v: flash_attention_rope(
        q, k, v, c2, s2, True, window=window), q, k, v, g)


def test_make_rope_tables_match_reference():
    """The same (cos, sin) give the same tables, bit for bit; the port's
    angles at Llama-3's theta 5e5 and positions up to 2048 agree with the
    reference's to float32 rounding."""
    cos, sin = _angles(2, 2048, 128, 500000.0)
    got = make_rope_tables(torch.from_numpy(cos), torch.from_numpy(sin))
    want = jax_make_rope_tables(jnp.asarray(cos), jnp.asarray(sin))
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (2, 2048, 128)
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    positions = torch.arange(2048).expand(2, 2048)
    for a, w in zip(pt._rope_angles(positions, 128, 500000.0), (cos, sin)):
        np.testing.assert_allclose(a.numpy(), w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hkv,dh,t", [(4, 32, 256), (2, 64, 256), (2, 32, 200)])
def test_rope_flash_matches_pallas_kernel_and_prerotated_oracle(hkv, dh, t):
    """The reference's ``test_rope_fused_matches_prerotated_oracle`` cases:
    the port against the interpret-mode Pallas kernel and against
    ``_rope_rotate`` + ``attention_reference`` of both packages, forward
    and dq, dk, dv, at 2e-5."""
    rng = np.random.default_rng(11)
    b, h = 2, 4
    q, k, v, g = _inputs(rng, b, t, h, hkv, dh)
    cos, sin = _angles(b, t, dh)
    got, got_grads = _port_rope(q, k, v, g, cos, sin)

    jc2, js2 = jax_make_rope_tables(jnp.asarray(cos), jnp.asarray(sin))
    cos4, sin4 = jnp.asarray(cos)[:, :, None], jnp.asarray(sin)[:, :, None]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(lambda q, k, v: jax_flash_attention_rope(
        q, k, v, jc2, js2, True, 128, 128, True), jq, jk, jv)
    oracle, ovjp = jax.vjp(lambda q, k, v: jax_attention_reference(
        jt._rope_rotate(q, cos4, sin4), jt._rope_rotate(k, cos4, sin4), v,
        causal=True), jq, jk, jv)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    for name, a, w, o in zip(("dq", "dk", "dv"), got_grads, vjp(jnp.asarray(g)),
                             ovjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(o), **TOL, err_msg=name)

    # the port's own rotate-then-attend (the path the model took before)
    c, s = torch.from_numpy(cos)[:, :, None], torch.from_numpy(sin)[:, :, None]
    pre, pre_grads = _port_vjp(lambda q, k, v: flash_attention(
        pt._rope_rotate(q, c, s), pt._rope_rotate(k, c, s), v, True), q, k, v, g)
    np.testing.assert_allclose(got, pre, **TOL)
    for name, a, w in zip(("dq", "dk", "dv"), got_grads, pre_grads):
        np.testing.assert_allclose(a, w, **TOL, err_msg=name)


def test_rope_flash_gqa_window_and_position_offset():
    """The reference's ``test_pallas_rope_gqa_window`` (window 9, GQA, 16-row
    tiles) at its 1e-4, with the tables built at positions 100.. so the
    rotation is not the identity on the first rows."""
    rng = np.random.default_rng(12)
    b, t, h, hkv, dh, window = 2, 40, 4, 2, 16, 9
    q, k, v, g = _inputs(rng, b, t, h, hkv, dh)
    cos, sin = _angles(b, t, dh, offset=100)
    got, got_grads = _port_rope(q, k, v, g, cos, sin, window)
    jc2, js2 = jax_make_rope_tables(jnp.asarray(cos), jnp.asarray(sin))
    want, vjp = jax.vjp(lambda q, k, v: jax_flash_attention_rope(
        q, k, v, jc2, js2, True, 16, 16, True, window),
        *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    for name, a, w in zip(("dq", "dk", "dv"), got_grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_rope_flash_refuses_window_without_causal_and_gives_tables_no_grad():
    x = torch.zeros(1, 8, 2, 4)
    c2, s2 = make_rope_tables(torch.ones(1, 8, 2), torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match="causal"):
        flash_attention_rope(x, x, x, c2, s2, False, window=4)
    c2.requires_grad_()
    q = torch.randn(1, 8, 2, 4, requires_grad=True)
    out = flash_attention_rope(q, x, x, c2, s2)
    dq, dc2 = torch.autograd.grad(out.sum(), (q, c2), allow_unused=True)
    assert dq is not None and dc2 is None


LLAMA = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48,
             activation="swiglu", norm="rmsnorm", attn_bias=False, ffn_bias=False,
             pos_encoding="rotary", n_kv_heads=2, rope_theta=500000.0)
GPT2 = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48,
            activation="gelu", norm="layernorm", attn_bias=True, ffn_bias=True,
            pos_encoding="learned", tie_embeddings=True)


def _counting(monkeypatch, name):
    """Wrap ``elephas_tpu_torch.models.transformer.<name>`` to count its
    calls."""
    calls = []
    real = getattr(pt, name)

    def wrapped(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(pt, name, wrapped)
    return calls


def _batch(t=32):
    return make_lm_batches(np.random.default_rng(0).integers(0, 17, size=(4, t + 1)))


@pytest.mark.parametrize("config", ["llama", "gpt2"])
def test_model_routes_rotary_flash_through_the_fused_entry(monkeypatch, config):
    """A rotary model trained on ``attn="flash"`` calls ``flash_attention_rope``
    once per layer with q and k UNROTATED (the only rotation left is the
    returned, cacheable k: one ``_rope_rotate`` per layer, not two) and never
    the plain ``flash_attention``; ``prefill`` keeps rotate-first and the plain
    entry, as the reference's does. A learned-position model never reaches
    the fused entry."""
    cfg = LLAMA if config == "llama" else GPT2
    model = TransformerLM(**cfg, device="cpu")
    params = model.init(0)
    fused = _counting(monkeypatch, "flash_attention_rope")
    plain = _counting(monkeypatch, "flash_attention")
    rotations = _counting(monkeypatch, "_rope_rotate")
    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-2), attn="flash")
    tok, pos, tg = _batch()
    _, _, loss = step(params, opt_init(params), tok, pos, tg)
    assert np.isfinite(float(loss))
    L = cfg["n_layers"]
    if config == "llama":
        assert (len(fused), len(plain), len(rotations)) == (L, 0, L)
        # the q handed to the kernel is the projection itself, unrotated
        lp = {k_: v_[0] for k_, v_ in params.items() if k_ in model._block_keys()}
        x = model._norm_h(lp, "ln1", model._embed(params, torch.as_tensor(tok).long(),
                                                  torch.as_tensor(pos).long()))
        q0 = model._attn_proj(lp, "q", x).reshape(4, 32, 4, 4)
        torch.testing.assert_close(fused[0][0].detach(), q0.detach())
    else:
        assert (len(fused), len(plain), len(rotations)) == (0, L, 0)
    del fused[:], plain[:], rotations[:]
    model.prefill(params, tok[:, :8], model.init_cache(4, 16))
    assert len(fused) == 0 and len(plain) == L


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_rope_flash_under_remat_and_accum_matches_dense(remat):
    """``remat`` and ``accum_steps`` over the fused autograd Function: the
    first step's loss and gradients equal the plain ``attn="dense"`` path's
    (rotate first, autograd through PyTorch ops) to 1e-5."""
    model = TransformerLM(**LLAMA, device="cpu")
    params = model.init(1)
    batch = _batch()
    want_loss, want = build_lm_train_step(model, None, adam_compact(1e-2),
                                          attn="dense")[0].grad(params, *batch)
    got_loss, got = build_lm_train_step(model, None, adam_compact(1e-2), attn="flash",
                                        remat=remat, accum_steps=2)[0].grad(params, *batch)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for k_ in want:
        torch.testing.assert_close(got[k_], want[k_], atol=1e-5, rtol=1e-5)


# -- the repaired signatures: reference-shaped positional calls --------------------


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind is not inspect.Parameter.KEYWORD_ONLY and p.name != "self"]


@pytest.mark.parametrize("port,ref", [
    (flash_attention, jax_flash_attention),
    (flash_attention_with_lse, jax_flash_attention_with_lse),
    (flash_attention_tpu, jax_flash_attention_tpu),
    (flash_attention_rope, jax_flash_attention_rope),
    (make_rope_tables, jax_make_rope_tables),
    (flash_decode, jax_fd.flash_decode),
    (port_fd.flash_decode_lse, jax_fd.flash_decode_lse),
    (TransformerLM.apply, jt.TransformerLM.apply),
    (TransformerLM.apply_with_aux, jt.TransformerLM.apply_with_aux),
    (TransformerLM.apply_hidden, jt.TransformerLM.apply_hidden),
    (TransformerLM.loss, jt.TransformerLM.loss),
    (build_mesh, jax_build_mesh),
], ids=lambda f: f.__qualname__)
def test_signature_matches_reference(port, ref):
    """Names, order and defaults of every positional parameter are the
    reference's (the port may add keyword-only ones after them)."""
    assert _params(port) == _params(ref)


def test_flash_attention_positional_block_size_is_full_causal():
    """``flash_attention(q, k, v, True, 128)`` is full causal attention in
    both packages (128 is the reference's block size, not a window)."""
    rng = np.random.default_rng(13)
    q, k, v, _ = _inputs(rng, 1, 256, 2, 2, 16)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), True, 128).numpy()
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), True, 128))
    full = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), True).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, full, **TOL)


def test_flash_attention_with_lse_positional_window():
    """``(q, k, v, causal, block_q, block_k, interpret, window)`` by
    position: the window lands in its place in both packages."""
    rng = np.random.default_rng(14)
    q, k, v, _ = _inputs(rng, 1, 37, 4, 2, 16)
    o, lse = flash_attention_with_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                      True, 16, 16, True, 10)
    jo, jlse = jax_flash_attention_with_lse(*(jnp.asarray(a) for a in (q, k, v)),
                                            True, 16, 16, True, 10)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


def test_flash_attention_tpu_positional_window_and_grads():
    """The reference's public Pallas entry exists under its name:
    ``(q, k, v, causal, block_q, block_k, interpret, window)`` by position
    gives the reference's output and gradients."""
    rng = np.random.default_rng(16)
    q, k, v, g = _inputs(rng, 1, 37, 4, 2, 16)
    got, got_grads = _port_vjp(
        lambda q, k, v: flash_attention_tpu(q, k, v, True, 16, 16, True, 10), q, k, v, g)
    want, vjp = jax.vjp(lambda q, k, v: jax_flash_attention_tpu(q, k, v, True, 16, 16, True, 10),
                        *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for a, w in zip(got_grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(w), **TOL)


def test_flash_decode_positional_interpret():
    """``flash_decode(q, k, v, pos, interpret, window, ring)``: ``interpret``
    sits at position 4, so a reference-shaped call binds the window where
    the reference does; the port's entry is the kernel, which refuses a CPU
    tensor (the CPU path is ``decode_attention``), and equals the
    reference's kernel through ``decode_attention`` there."""
    rng = np.random.default_rng(15)
    q = rng.normal(size=(2, 2, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 40, 16)).astype(np.float32) for _ in range(2))
    want = jax_fd.flash_decode(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.asarray(30, jnp.int32), True, 8, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (flash_decode, port_fd.flash_decode_lse):
        with pytest.raises(ValueError, match="CUDA"):
            fn(tq, tk, tv, 30, True, 8, False)
    got = port_fd.decode_attention(tq, tk, tv, 30, 8, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_transformer_positional_seq_axis_and_remat():
    """``apply_with_aux(params, tokens, positions, attn, seq_axis,
    grad_reduce, remat)``, ``apply(..., attn, seq_axis)`` and ``loss(...,
    attn, seq_axis)`` by position in both packages; a ``grad_reduce`` raises, naming its ROADMAP item."""
    npp = jt.TransformerLM(**LLAMA).init(2)
    tok, pos, tg = _batch()
    jm, jp = jt.TransformerLM(**LLAMA), {k_: jnp.asarray(v_) for k_, v_ in npp.items()}
    model, params = TransformerLM(**LLAMA, device="cpu"), from_jax_params(npp, device="cpu")
    logits, aux = model.apply_with_aux(params, tok, pos, "flash", "seq", None, "full")
    jlogits, jaux = jm.apply_with_aux(jp, jnp.asarray(tok), jnp.asarray(pos), "flash",
                                      "seq", None, "full")
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(
        model.apply(params, tok, pos, "flash", "seq").detach().numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(tok), jnp.asarray(pos), "flash", "seq")),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        float(model.loss(params, tok, pos, tg, "flash", "seq")),
        float(jm.loss(jp, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(tg),
                      "flash", "seq")), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="item 6"):
        model.apply_hidden(params, tok, pos, "flash", "seq", lambda lps: lps)


def test_build_mesh_positional_axis_name_and_version():
    """``build_mesh(num_devices, devices, axis_name)`` by position names the
    axis in both packages (the port's ``device`` is keyword-only after
    it); both packages report the same ``__version__``."""
    mesh = build_mesh(1, None, "batch", device="cpu")
    assert mesh.axis_names == jax_build_mesh(1, None, "batch").axis_names == ("batch",)
    assert mesh.device == torch.device("cpu")
    assert build_mesh(device="cpu").axis_names == ("data",)
    assert elephas_tpu_torch.__version__ == elephas_tpu.__version__ == "0.1.0"
