"""The port's decode attention (CPU path = its plain version) against the
JAX package's flash-decode Pallas kernel in interpret mode, on the same
numpy inputs: GQA group sizes, scalar and per-row positions, sliding
windows, rolling (ring) caches and bfloat16 caches."""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_paged_attention import _combine, _online_softmax, _tile_grid

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


# -- K4's split rule (shared with K5-decode), and its arithmetic emulated --------


def _reference_slots(pos, T, window, ring):
    """The slots the plain version's mask keeps for a row at ``pos``."""
    slots = np.arange(T)
    if ring:
        return slots[np.mod(pos - slots, T) < min(pos + 1, window)]
    keep = slots <= pos
    if window is not None:
        keep &= slots > pos - window
    return slots[keep]


@pytest.mark.parametrize("window,ring", [(None, False), (1, False), (7, False),
                                         (40, False), (1, True), (7, True),
                                         (40, True), (100, True)])
def test_dense_pieces_cover_the_logical_range_once(window, ring):
    """For every position of a 64-slot cache up to 3T and 1 to 9 splits:
    the pieces are contiguous in split order over the logical range
    ``decode_range`` gives (each position once), start on a 16-row unit
    counted from ``lo``, differ by at most one unit, and map (``j mod T`` in
    a ring) to exactly the slots the plain version's mask keeps."""
    T = 64
    for n_split in range(1, 10):
        for pos in range(3 * T):
            lo, hi = fd.decode_range(pos, T, window, ring)
            pieces = fd.decode_pieces(pos, T, n_split, T, window, ring)
            assert len(pieces) == n_split
            assert pieces[0][0] == lo and pieces[-1][1] == hi
            rows = [r for a, b in pieces for r in range(a, b)]
            assert rows == list(range(lo, hi))
            lengths = [b - a for a, b in pieces]
            assert max(lengths) - min(lengths) <= 16
            assert all((a - lo) % 16 == 0 for a, b in pieces if b > a)
            slots = sorted(r % T for r in rows) if ring else rows
            assert slots == _reference_slots(pos, T, window, ring).tolist()


def _emulated_k4(q, k, v, pos, window, ring, n_split, bt=32, warps=4):
    """K4's arithmetic in plain PyTorch: each split's piece (from
    ``decode_pieces``, the cache one page of T rows) walked in ``bt``-row
    tiles, each of ``warps`` warps owning a quarter of every tile's keys
    with its own online softmax (running max m, denominator l,
    unnormalised accumulator); the warps merged once in warp order, then
    the combine over the splits: M = max over non-empty splits, L = sum
    l_i exp(m_i - M), out = sum exp(m_i - M) acc_i / L, lse = M + log L.
    Every row's every (split, warp) runs as one lane of the paged test's
    :func:`_online_softmax` (rows taken mod T on a ring)."""
    B, Hkv, G, Dh = q.shape
    T = k.shape[2]
    pieces = [fd.decode_pieces(int(p), T, n_split, T, window, ring) for p in pos]
    j, valid = _tile_grid(pieces, bt, bt // warps, warps)
    if ring:
        j = j % T
    m, l_, acc = _online_softmax(q, k, v, j, valid, Dh ** -0.5)
    # the warps' merge per piece; an empty piece stays (-inf, 0, 0)
    m, l_, acc = (x.reshape(B, n_split, warps, *x.shape[2:]) for x in (m, l_, acc))
    M = m.amax(2)
    wt = torch.where(M[:, :, None] > -torch.inf, torch.exp(m - M[:, :, None]), 0.0)
    return _combine(M, (wt * l_).sum(2), (wt[..., None] * acc).sum(2))


@pytest.mark.parametrize("mode", ["plain", "window", "ring", "window_past_T"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("n_split", [3, 6])
def test_k4_split_rule_emulation_matches_plain_at_every_position(mode, g, n_split):
    """The emulated K4 (per-split pieces cut by ``pos``, 32-row tiles, a
    per-warp online softmax, the warps' merge and the combine) against
    ``decode_attention_reference_lse`` at atol = rtol = 2e-5, one row at
    each position: 0 .. T-1 of a 64-slot cache (plain and a window of 7),
    0 .. 2T-1 of a ring of window 40, and T .. T+5 under a window of 7 (a
    sequence-sharded rank's pos past its T)."""
    T, window, ring = 64, None, False
    positions = np.arange(T)
    if mode == "window":
        window = 7
    elif mode == "ring":
        window, ring, positions = 40, True, np.arange(2 * T)
    elif mode == "window_past_T":
        window, positions = 7, np.arange(T, T + 6)
    rng = np.random.default_rng(10 * g + n_split)
    B = len(positions)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, B, 2, g, 32, T))
    pos = torch.from_numpy(positions.astype(np.int32))
    got = _emulated_k4(q, k, v, pos, window, ring, n_split)
    want = fd.decode_attention_reference_lse(q, k, v, pos, window, ring)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)
