"""The port's flash attention (CPU path = the plain versions of K2-fwd,
K2-dq and K2-dkv under its autograd Function) against the JAX package's
Pallas kernels in interpret mode with small tiles, and against both
packages' dense ``attention_reference``, forward and gradients, on the same
numpy inputs. Tolerances are the reference's own for its kernels
(``tests/ops/test_pallas_flash.py``): 2e-5 in float32, 2e-2 in bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops import attention_reference as jax_attention_reference
from elephas_tpu.ops.pallas_flash import flash_attention_tpu
from elephas_tpu.ops.pallas_flash import \
    flash_attention_with_lse as jax_flash_attention_with_lse
from elephas_tpu_torch.ops.flash_attention import (attention_reference,
                                                   flash_attention,
                                                   flash_attention_dq,
                                                   flash_attention_fwd,
                                                   flash_attention_with_lse,
                                                   repeat_kv_heads)

TOL = dict(atol=2e-5, rtol=2e-5)
BLOCK = 16   # small Pallas tiles, so T=37 and T=48 span several of them

CASES = [
    # B, T, H, Hkv, Dh, causal, window
    (2, 32, 2, 2, 16, True, None),
    (1, 37, 4, 2, 16, True, None),      # grouped-query, T not a tile multiple
    (1, 37, 2, 1, 8, False, None),      # non-causal, ragged, MQA
    (1, 48, 2, 1, 16, True, 12),        # sliding window + GQA
]


def _inputs(rng, b, t, h, hkv, dh):
    return (rng.normal(size=(b, t, h, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, t, h, dh)).astype(np.float32))


def _port_vjp(fn, q, k, v, cts):
    """Forward outputs and input gradients of ``fn`` (the port) for the
    output cotangents ``cts``, all as numpy."""
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    grads = torch.autograd.grad(loss, args)
    return ([o.detach().float().numpy() for o in outs],
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("b,t,h,hkv,dh,causal,window", CASES)
def test_forward_and_grads_match_pallas_kernel_and_dense(b, t, h, hkv, dh,
                                                         causal, window):
    rng = np.random.default_rng(0)
    q, k, v, g = _inputs(rng, b, t, h, hkv, dh)
    (got,), got_grads = _port_vjp(
        lambda q, k, v: flash_attention(q, k, v, causal, window), q, k, v, (g,))

    def kernel(q, k, v):
        return flash_attention_tpu(q, k, v, causal, BLOCK, BLOCK, True, window)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want, vjp = jax.vjp(kernel, jq, jk, jv)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for name, a, w in zip(("dq", "dk", "dv"), got_grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)

    # the dense oracles of both packages, gradients included
    (dense,), dense_grads = _port_vjp(
        lambda q, k, v: attention_reference(q, k, v, causal, window), q, k, v, (g,))
    jdense, jvjp = jax.vjp(
        lambda q, k, v: jax_attention_reference(q, k, v, causal, window),
        jq, jk, jv)
    np.testing.assert_allclose(dense, np.asarray(jdense), **TOL)
    np.testing.assert_allclose(got, dense, **TOL)
    for name, a, w, jw in zip(("dq", "dk", "dv"), got_grads, dense_grads,
                              jvjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, w, **TOL, err_msg=name)
        np.testing.assert_allclose(w, np.asarray(jw), **TOL, err_msg=name)


@pytest.mark.parametrize("hkv,window", [(4, None), (2, 10)])
def test_with_lse_and_nonzero_lse_cotangent(hkv, window):
    """``(o, lse)`` and the gradients for cotangents on BOTH outputs: the
    lse cotangent folds into Δ as Δ − g_lse."""
    rng = np.random.default_rng(1)
    b, t, h, dh = 1, 37, 4, 16
    q, k, v, g = _inputs(rng, b, t, h, hkv, dh)
    g_lse = rng.normal(size=(b, t, h)).astype(np.float32)
    (o, lse), grads = _port_vjp(
        lambda q, k, v: flash_attention_with_lse(q, k, v, True, window),
        q, k, v, (g, g_lse))
    assert lse.shape == (b, t, h) and lse.dtype == np.float32

    def kernel(q, k, v):
        return jax_flash_attention_with_lse(q, k, v, True, BLOCK, BLOCK, True,
                                            window)

    (jo, jlse), vjp = jax.vjp(kernel, *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(o, np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse, np.asarray(jlse), **TOL)
    for name, a, w in zip(("dq", "dk", "dv"), grads,
                          vjp((jnp.asarray(g), jnp.asarray(g_lse)))):
        np.testing.assert_allclose(a, np.asarray(w), **TOL, err_msg=name)


def test_bf16_inputs():
    """bf16 in, bf16 out, float32 inside; the tolerance is bf16's (2e-2,
    the reference's ``test_bf16_inputs_roundtrip``)."""
    rng = np.random.default_rng(2)
    q, k, v, g = _inputs(rng, 1, 40, 2, 1, 16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, True)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want, vjp = jax.vjp(lambda q, k, v: flash_attention_tpu(
        q, k, v, True, BLOCK, BLOCK, True), jq, jk, jv)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)
    grads = torch.autograd.grad(
        (out.float() * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, w in zip(("dq", "dk", "dv"), grads,
                          vjp(jnp.asarray(g, jnp.bfloat16))):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=name)


def test_repeat_kv_heads_matches_reference_order():
    from elephas_tpu.ops.flash_attention import \
        repeat_kv_heads as jax_repeat_kv_heads

    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    got = repeat_kv_heads(torch.from_numpy(x), 6).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_repeat_kv_heads(jnp.asarray(x), 6)))
    with pytest.raises(ValueError, match="divide"):
        repeat_kv_heads(torch.from_numpy(x), 5)


def test_window_needs_causal_and_kernels_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(x, x, x, causal=False, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x, True)
    stats = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dq(x, x, x, x, stats, stats, True)
