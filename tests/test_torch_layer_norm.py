"""The port's LayerNorm (CPU path = its plain version, differentiated by
autograd) against the JAX package's fused Pallas kernel (interpret mode,
its custom VJP under ``jax.grad`` for the gradients) and its jnp
reference, on the same numpy inputs; ``fused_layer_norm``'s signature
against the reference's (``interpret`` last); K3-bwd's pass-1 grid, which
depends on the row count alone; and K3-fwd's rows-route arithmetic (one
warp a row: the lane-column map, the row mean summed in double by each lane
and then by a butterfly, the centred variance in float32) emulated in numpy
against a float64 oracle at the card tests' 1e-5 pin."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops import fused_layer_norm as jax_fused_layer_norm
from elephas_tpu.ops import layer_norm_reference as jax_layer_norm_reference
from elephas_tpu_torch.ops import (fused_layer_norm, fused_layer_norm_bwd,
                                   layer_norm)
from elephas_tpu_torch.ops.layer_norm import _BWD_BLOCKS, _bwd_grid

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


def test_fused_layer_norm_signature_and_positional_interpret():
    """``fused_layer_norm(x, scale, bias, eps, interpret)``: the reference's
    names, order and defaults (its entry is a ``jax.custom_vjp``: compared
    through ``.fun``). A reference-shaped positional call reaches the
    port's kernel entry, which refuses a CPU tensor (the CPU path is
    ``layer_norm``), and ``layer_norm`` equals the reference's kernel run
    that way in interpret mode."""
    def params(fn):
        fn = getattr(fn, "fun", fn)
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(fused_layer_norm) == params(jax_fused_layer_norm)
    rng = np.random.default_rng(8)
    x, s, b = _inputs(rng, 6, 96)
    with pytest.raises(ValueError, match="CUDA"):
        fused_layer_norm(*(torch.from_numpy(a) for a in (x, s, b)), 1e-5, True)
    want = jax_fused_layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5, True)
    np.testing.assert_allclose(_port(x, s, b), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N", [1, 7, 263, 264, 265, 1100, 8192, 8193, 100000])
def test_bwd_grid_depends_on_rows_alone(N):
    """K3-bwd's pass 1 runs ``n_blocks`` blocks of ``rows`` contiguous rows:
    at most ``_BWD_BLOCKS``, none empty, every row covered, from ``N``
    alone (not the width, the route or the card), so the order of every
    dscale/dbias sum, and so its bits, is fixed by the row count."""
    assert list(inspect.signature(_bwd_grid).parameters) == ["N"]
    n_blocks, rows = _bwd_grid(N)
    assert 1 <= n_blocks <= _BWD_BLOCKS
    assert (n_blocks - 1) * rows < N <= n_blocks * rows
    assert _bwd_grid(N) == (n_blocks, rows)


def _butterfly(v):
    """The warp's xor-shuffle sum over lanes (the last axis, 32): every lane
    ends with the same total, summed in the same order."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v


def _emulated_rows_fwd(x, s, b, vec, eps=1e-5):
    """K3-fwd's rows route (``layer_norm_fwd_rows_kernel``) in numpy: lane l
    holds columns 4 (l + 32 j) + e when ``vec``, else (4 j + e) 32 + l; it
    sums its x in double in (j, e) order, the butterfly gives the mean;
    x - mean is formed in double and rounded; the centred squares are
    summed in float32 (each step one fused multiply-add) and butterflied;
    rstd = 1 / sqrt(var + eps) in float32; y = c rstd scale + bias."""
    n, d = x.shape
    nv = -(-d // 128)
    lane, j, e = np.meshgrid(np.arange(32), np.arange(nv), np.arange(4), indexing="ij")
    cols = (4 * (lane + 32 * j) + e if vec else (4 * j + e) * 32 + lane).reshape(32, -1)
    live = cols < d
    at = np.minimum(cols, d - 1)
    xs = np.where(live, x[:, at], np.float32(0))              # [n, 32, 4 nv]
    sd = np.zeros((n, 32))
    for k in range(xs.shape[2]):
        sd = sd + xs[:, :, k].astype(np.float64)
    sd = _butterfly(sd)
    assert (sd == sd[:, :1]).all()
    mean = sd[:, :1, None] / d
    c = np.where(live, (xs.astype(np.float64) - mean).astype(np.float32), np.float32(0))
    ss = np.zeros((n, 32), np.float32)
    for k in range(c.shape[2]):
        ck = c[:, :, k].astype(np.float64)
        ss = (ck * ck + ss.astype(np.float64)).astype(np.float32)
    ss = _butterfly(ss)
    var = ss[:, :1, None] / np.float32(d)
    rstd = (1.0 / np.sqrt((var + np.float32(eps)).astype(np.float64))).astype(np.float32)
    ys = c * rstd * s[at] + b[at]
    out = np.zeros((n, d), np.float32)
    out[:, cols[live]] = ys[:, live]
    return out


@pytest.mark.parametrize("d", [768, 1000, 1024])
@pytest.mark.parametrize("vec", [True, False])
def test_rows_route_emulation_holds_the_pin(d, vec):
    """The emulated rows route against LayerNorm in float64 at atol = rtol =
    1e-5, the card tests' pin, on rows of N(1, 3) and on a row at 1e4 (where
    a float32 row mean would round visibly), for both lane-column maps."""
    rng = np.random.default_rng(d)
    x, s, b = _inputs(rng, 16, d)
    x[0] += 1e4
    got = _emulated_rows_fwd(x, s, b, vec)
    x64 = x.astype(np.float64)
    mu = x64.mean(-1, keepdims=True)
    want = (x64 - mu) / np.sqrt(((x64 - mu) ** 2).mean(-1, keepdims=True) + 1e-5) * s + b
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
