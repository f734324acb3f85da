"""The port's fused classification loss (``elephas_tpu_torch/ops/fused_xent.py``)
on CPU tensors, where the dispatcher runs K1's plain versions: against the
JAX package's Pallas kernels in interpret mode (forward, and the gradient
through its custom VJP under ``jax.vjp``), including rows whose labels are
all zero or sum to 2, where the kernel's ``sum(y * (lse - x))`` departs from
the oracle ``lse - <y, x>``; against the oracle on one-hot rows; bf16
logits; and the CUDA wrappers' refusal of CPU tensors. The CUDA kernels are
held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: float32 at atol = rtol = 1e-5 (row sums of at most 1000
float32 terms in another order); bf16 logits at 1e-5 for the loss (both
sides widen the same bf16 values to float32) and one bf16 ulp (2**-8
relative) for the gradient, which both sides round to bf16 once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops import pallas_ops as JP
from elephas_tpu_torch.ops import fused_xent as X

TOL = 1e-5


def _case(B, C, seed=0, rows="mixed"):
    """Logits ``[B, C]`` and labels: one-hot, with row 0 all zero and row 1
    soft (summing to 2) when ``rows == "mixed"`` and B allows it."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, C)) * 3).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=B)]
    if rows == "mixed":
        y[0] = 0.0
        if B > 1:
            y[1] = 0.0
            y[1, : min(C, 3)] = [0.5, 1.0, 0.5][: min(C, 3)]
    g = rng.normal(size=(B,)).astype(np.float32)
    return x, y, g


def _jax_vjp(x, y, g):
    out, vjp = jax.vjp(lambda a: JP.fused_xent_from_logits(a, jnp.asarray(y), True),
                       jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port_vjp(x, y, g):
    xt = torch.from_numpy(x).requires_grad_()
    out = X.categorical_crossentropy_from_logits(xt, torch.from_numpy(y))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    return out.detach(), dx


@pytest.mark.parametrize("B", [1, 13, 64])
@pytest.mark.parametrize("C", [10, 130, 1000])
def test_plain_versions_match_pallas_kernel(B, C):
    x, y, g = _case(B, C, seed=B * 1000 + C)
    want, want_dx = _jax_vjp(x, y, g)
    xt, yt, gt = (torch.from_numpy(a) for a in (x, y, g))
    fwd = X.fused_xent_fwd_reference(xt, yt)
    bwd = X.fused_xent_bwd_reference(xt, yt, gt)
    assert fwd.dtype == torch.float32 and fwd.shape == (B,)
    np.testing.assert_allclose(fwd.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(bwd.numpy(), want_dx, atol=TOL, rtol=TOL)
    # the autograd Function of the dispatcher runs the same pair
    out, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=TOL, rtol=TOL)


def test_unnormalised_rows_keep_the_kernels_arithmetic():
    """A zero-label row gives 0 and a row summing to 2 gives 2 lse - <y, x>
    (the oracle gives lse and lse - <y, x>); the backward is the oracle's
    gradient on both."""
    x, y, g = _case(4, 10, seed=3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    fwd = X.fused_xent_fwd_reference(xt, yt).numpy()
    lse = torch.logsumexp(xt, dim=-1).numpy()
    dot = (y * x).sum(-1)
    assert fwd[0] == 0.0
    np.testing.assert_allclose(fwd[1], 2 * lse[1] - dot[1], rtol=TOL)
    oracle = X.xent_from_logits_reference(xt, yt).numpy()
    np.testing.assert_allclose(oracle[:2], lse[:2] - dot[:2], rtol=TOL)
    assert abs(fwd[0] - oracle[0]) > 1.0
    xg = xt.clone().requires_grad_()
    (want_dx,) = torch.autograd.grad(X.xent_from_logits_reference(xg, yt), xg,
                                     torch.from_numpy(g))
    _, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("C", [10, 257])
def test_dispatcher_matches_jax_dispatcher_on_one_hot_rows(C):
    """On the CPU the JAX dispatcher runs its oracle; on one-hot rows the
    kernel's arithmetic is the same function."""
    x, y, g = _case(24, C, seed=C, rows="one_hot")
    want = JP.categorical_crossentropy_from_logits(jnp.asarray(x), jnp.asarray(y))
    want_dx = jax.grad(lambda a: jnp.sum(
        JP.categorical_crossentropy_from_logits(a, jnp.asarray(y)) * g))(jnp.asarray(x))
    out, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=TOL, rtol=TOL)
    oracle = X.xent_from_logits_reference(torch.from_numpy(x), torch.from_numpy(y))
    want_oracle = JP.xent_from_logits_reference(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want_oracle), atol=TOL, rtol=TOL)


def test_bf16_logits():
    x, y, g = _case(13, 130, seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    out, vjp = jax.vjp(lambda a: JP.fused_xent_from_logits(a, jnp.asarray(y), True), xj)
    want_dx = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    xt = xb.clone().requires_grad_()
    got = X.categorical_crossentropy_from_logits(xt, torch.from_numpy(y))
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert got.dtype == torch.float32 and dx.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=2 ** -8, rtol=2 ** -8)


def test_cuda_wrappers_refuse_cpu_tensors():
    x, y, g = (torch.from_numpy(a) for a in _case(4, 10))
    before = (X.fused_xent_fwd.launches, X.fused_xent_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_fwd(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_bwd(x, y, g)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_from_logits(x, y)
    assert (X.fused_xent_fwd.launches, X.fused_xent_bwd.launches) == before


@pytest.mark.parametrize("B,C", [(13, 10), (8, 130)])
def test_positional_interpret_matches_pallas_kernel(B, C):
    """``fused_xent_from_logits(x, y, True)`` by position in both packages:
    the reference runs its Pallas kernel in interpret mode; the port's entry
    takes the call (no ``TypeError``) and, as a kernel entry, refuses CPU
    tensors, so on the CPU its dispatcher (the same kernels' plain
    versions) gives the loss and the gradient, equal to the reference's at
    its tolerance. On the card the entry itself runs
    (``tests/test_torch_cuda.py``)."""
    x, y, g = _case(B, C, seed=B + C)
    want, want_dx = _jax_vjp(x, y, g)   # JP.fused_xent_from_logits(a, y, True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_from_logits(xt, yt, True)
    with pytest.raises(ValueError, match="CUDA"):
        X.fused_xent_from_logits(xt, yt, interpret=False)
    out, dx = _port_vjp(x, y, g)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=TOL, rtol=TOL)
