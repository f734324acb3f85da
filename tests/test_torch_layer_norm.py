"""The port's LayerNorm (CPU path = its plain version, differentiated by
autograd) against the JAX package's fused Pallas kernel (interpret mode,
its custom VJP under ``jax.grad`` for the gradients) and its jnp
reference, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops import fused_layer_norm as jax_fused_layer_norm
from elephas_tpu.ops import layer_norm_reference as jax_layer_norm_reference
from elephas_tpu_torch.ops import (fused_layer_norm, fused_layer_norm_bwd,
                                   layer_norm)

SHAPES = [
    (8, 128),     # exact TPU tiles
    (5, 96),      # both dims padded on the TPU side
    (13, 384),
    (16, 200),    # D not a multiple of 128
    (8, 1000),
]


def _inputs(rng, n, d, offset=0.0):
    x = (rng.normal(size=(n, d)) * 3 + 1 + offset).astype(np.float32)
    s = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    b = rng.normal(size=(d,)).astype(np.float32)
    return x, s, b


def _port(x, s, b):
    return layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                      torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_fused_kernel_and_reference(shape):
    rng = np.random.default_rng(0)
    x, s, b = _inputs(rng, *shape)
    got = _port(x, s, b)
    assert got.dtype == np.float32
    kernel = jax_fused_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                  jnp.asarray(b), 1e-5, True)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=1e-5, rtol=1e-5)
    ref = jax_layer_norm_reference(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_leading_batch_dims():
    rng = np.random.default_rng(1)
    x, s, b = _inputs(rng, 14, 96)
    x3 = x.reshape(2, 7, 96)
    got = _port(x3, s, b)
    assert got.shape == (2, 7, 96)
    want = jax_fused_layer_norm(jnp.asarray(x3), jnp.asarray(s),
                                jnp.asarray(b), 1e-5, True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(8, 768), (5, 200)])
def test_large_offset_centred_variance(shape):
    """A row riding at 1e4: the centred variance keeps the result finite and
    close to a float64 oracle. Both float32 implementations round the row
    mean differently at this magnitude, so the pin is the reference's own
    for this case (tests/ops/test_layer_norm.py, atol/rtol 5e-2)."""
    rng = np.random.default_rng(6)
    x, s, b = _inputs(rng, *shape, offset=1e4)
    got = _port(x, s, b)
    assert np.isfinite(got).all()
    x64 = x.astype(np.float64)
    mu = x64.mean(-1, keepdims=True)
    want = (x64 - mu) / np.sqrt(x64.var(-1, keepdims=True) + 1e-5) * s + b
    np.testing.assert_allclose(got, want.astype(np.float32),
                               atol=5e-2, rtol=5e-2)
    kernel = jax_fused_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                  jnp.asarray(b), 1e-5, True)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("shape", [(8, 128), (5, 96), (8, 1000), (2, 7, 96)])
def test_gradients_match_fused_kernel_vjp(shape):
    """dx, dscale and dbias for a random cotangent against the Pallas
    backward kernel (``_fused_bwd``) under ``jax.grad``; atol/rtol 1e-4,
    the reference's own pin (tests/ops/test_layer_norm.py:68). D=1000 pads
    on the TPU side; (2, 7, 96) has leading batch dims."""
    rng = np.random.default_rng(2)
    d = shape[-1]
    x, s, b = _inputs(rng, int(np.prod(shape[:-1])), d)
    x = x.reshape(shape)
    g = rng.normal(size=shape).astype(np.float32)

    def jax_loss(x, s, b):
        out = jax_fused_layer_norm(x, s, b, 1e-5, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, s, b)]
    out = layer_norm(*args)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), args)
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        assert tuple(a.shape) == w.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernels never fall back to the plain version: a CPU tensor given
    to a CUDA wrapper raises, and only the dispatcher picks by device."""
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_layer_norm(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_layer_norm_bwd(x, torch.ones(8), x)
