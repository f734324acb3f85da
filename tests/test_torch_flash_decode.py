"""The port's decode attention (CPU path = its plain version) against the
JAX package's flash-decode Pallas kernel in interpret mode, on the same
numpy inputs: GQA group sizes, scalar and per-row positions, sliding
windows, rolling (ring) caches and bfloat16 caches."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the functions of the same name that both packages' ops
# export
fd = importlib.import_module("elephas_tpu_torch.ops.flash_decode")
jax_fd = importlib.import_module("elephas_tpu.ops.flash_decode")


def _qkv(rng, B, hkv, g, dh, T, kscale=1.0):
    q = rng.normal(size=(B, hkv, g, dh)).astype(np.float32)
    k = (rng.normal(size=(B, hkv, T, dh)) * kscale).astype(np.float32)
    v = rng.normal(size=(B, hkv, T, dh)).astype(np.float32)
    return q, k, v


def _both(q, k, v, pos, window=None, ring=False, dtype=np.float32):
    """(port, jax-kernel) pairs of (out, lse) as numpy."""
    tk = torch.bfloat16 if dtype != np.float32 else torch.float32
    jk = jnp.bfloat16 if dtype != np.float32 else jnp.float32
    tpos = torch.as_tensor(pos) if np.ndim(pos) else int(pos)
    o, l = fd.decode_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k).to(tk),
        torch.from_numpy(v).to(tk), tpos, window=window, ring=ring)
    jo, jl = jax_fd.flash_decode_lse(
        jnp.asarray(q), jnp.asarray(k, jk), jnp.asarray(v, jk),
        jnp.asarray(pos, jnp.int32), interpret=True, window=window,
        ring=ring)
    return (o.numpy(), l.numpy()), (np.asarray(jo), np.asarray(jl))


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 2), (1, 4)])
def test_gqa_scalar_positions(hkv, g):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 3, hkv, g, 16, 40)
    for pos in (0, 17, 39):
        got, want = _both(q, k, v, pos)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_per_row_positions_multi_block(g):
    """Per-row positions (the serving engine's form) across a cache longer
    than one TPU T-block, including block edges."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 4, 2, g, 8, 520, kscale=3.0)
    got, want = _both(q, k, v, np.array([0, 255, 256, 519], np.int32))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("window", [1, 7, 64])
def test_sliding_window(window):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 3, 2, 2, 16, 300)
    got, want = _both(q, k, v, np.array([5, 150, 299], np.int32),
                      window=window)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window", [4, 9])
def test_ring_cache(window):
    """Rolling buffer of T slots masked by slot age, over warm-up
    (pos < T) and steady state (pos >= T)."""
    rng = np.random.default_rng(3)
    T = 16
    q, k, v = _qkv(rng, 4, 2, 2, 8, T)
    got, want = _both(q, k, v, np.array([0, 3, 15, 40], np.int32),
                      window=window, ring=True)
    _close(got, want, 1e-5)


def test_bf16_cache_f32_softmax():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 2, 2, 16, 33)
    got, want = _both(q, k, v, 20, dtype="bfloat16")
    _close(got, want, 2e-2)


def test_aligned_cache_length_matches_reference():
    for n in list(range(1, 70)) + [255, 256, 257, 511, 1000, 1024, 1025, 4097]:
        assert fd.aligned_cache_length(n) == jax_fd.aligned_cache_length(n), n


def test_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 1, 1, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode_lse(q, k, v, 3)


def test_ring_requires_window():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 1, 1, 8, 8))
    with pytest.raises(ValueError, match="window"):
        fd.decode_attention_lse(q, k, v, 3, ring=True)
