"""The port's paged attention (``ops/paged_attention.py``) and the model's
paged methods on the CPU path.

- The plain versions against the JAX package's plain references
  (``paged_decode_reference_lse``, ``paged_chunk_reference``) on the same
  numpy pool and table, with a trash page poisoned by finite garbage:
  allclose at atol = rtol = 1e-5 in float32. The reference's own tests pin
  its Pallas kernels (interpret mode) to those references.
- Paged plain == dense plain bitwise within torch: the identity the paged
  engine's token equality rests on.
- ``decode_chunk_paged`` then ``decode_step_paged`` equal the dense
  ``decode_chunk`` / ``decode_step`` bitwise; an unmapped write lands in the
  trash page; ``decode_step_paged``'s logits match the JAX package's.
- The kernel entries' signatures are the reference's, ``interpret`` last:
  a reference-shaped positional call reaches the port's kernel wrapper
  (which refuses a CPU tensor) and, through the dispatcher, the reference's
  Pallas kernel's result in interpret mode.
- K5-decode's split rule (``decode_pieces``, which the CUDA kernel's blocks
  compute from ``pos`` and ``window``): the pieces cover each slot's
  visible range once, in split order, equal to within one alignment unit;
  and a plain-PyTorch emulation of the kernel's arithmetic over them (an
  online softmax per split over its tiles, then the log-sum-exp combine)
  equals the plain version at atol = rtol = 2e-5 for every position.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models.transformer import TransformerLM as JaxLM
from elephas_tpu_torch.models import TransformerLM, from_jax_params
from elephas_tpu_torch.ops.flash_decode import (chunk_attention_reference,
                                                decode_attention_reference_lse)
from elephas_tpu_torch.ops.paged_attention import (
    _splits, decode_pieces, paged_chunk_attention, paged_chunk_reference,
    paged_decode_attention_lse, paged_decode_reference_lse, paged_flash_chunk,
    paged_flash_decode, paged_flash_decode_lse, paged_view_rows)

jax_pa = importlib.import_module("elephas_tpu.ops.paged_attention")

S, Hkv, G, Dh = 3, 2, 2, 16
M = 5


def _setup(page, seed=0, trash=7.25, C=None):
    """numpy q, pools and table: a distinct page per (slot, logical page),
    scattered over the pool, and a trash page 0 of finite garbage."""
    rng = np.random.default_rng(seed)
    P = S * M + 1
    kp = rng.standard_normal((P, Hkv, page, Dh)).astype(np.float32)
    vp = rng.standard_normal((P, Hkv, page, Dh)).astype(np.float32)
    kp[0] = vp[0] = trash
    table = (1 + rng.permutation(S * M)).reshape(S, M).astype(np.int32)
    shape = (S, Hkv, G, Dh) if C is None else (S, Hkv, G, C, Dh)
    q = rng.standard_normal(shape).astype(np.float32)
    return q, kp, vp, table


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("window", [None, 11])
def test_decode_plain_matches_jax_reference(page, window):
    q, kp, vp, table = _setup(page, seed=page)
    T = M * page
    pos = np.array([5, 2 * page - 1, T - 1], np.int32)   # mid, edge, last
    table[0, 5 // page + 1:] = 0                          # unmapped tail
    o, l = paged_decode_reference_lse(*_t(q, kp, vp, table),
                                      torch.from_numpy(pos), page, window)
    jo, jl = jax_pa.paged_decode_reference_lse(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos)), page,
        window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("window", [None, 11])
def test_chunk_plain_matches_jax_reference(page, window):
    C = 4
    q, kp, vp, table = _setup(page, seed=10 + page, C=C)
    T = M * page
    pos0 = np.array([3, page - 1, T - C], np.int32)   # straddles, edge, end
    got = paged_chunk_reference(*_t(q, kp, vp, table), torch.from_numpy(pos0),
                                page, window)
    want = jax_pa.paged_chunk_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos0)), page,
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("window", [None, 11])
def test_paged_plain_bitwise_equals_dense_plain(window):
    """Decode and chunk through the table equal the dense functions on the
    gathered cache bit for bit; a trash page at 1e4 inside the visible
    range's pages is masked exactly."""
    page = 8
    q, kp, vp, table = _setup(page, seed=3, trash=1e4)
    table[1, 1:] = 0
    q, kp, vp, table = _t(q, kp, vp, table)
    kd, vd = paged_view_rows(kp, table, page), paged_view_rows(vp, table, page)
    pos = torch.tensor([5, 4, M * page - 1], dtype=torch.int32)
    for a, b in zip(paged_decode_reference_lse(q, kp, vp, table, pos, page,
                                               window),
                    decode_attention_reference_lse(q, kd, vd, pos, window)):
        assert torch.equal(a, b)
    C = 4
    qc = torch.from_numpy(_setup(page, seed=4, C=C)[0])
    pos0 = torch.tensor([3, 0, 30])
    pos_b = pos0[:, None] + torch.arange(C)
    assert torch.equal(
        paged_chunk_reference(qc, kp, vp, table, pos0, page, window),
        chunk_attention_reference(qc, kd, vd, pos_b, window))


def test_kernel_wrappers_raise_on_cpu_tensors():
    q, kp, vp, table = _t(*_setup(8))
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_decode_lse(q, kp, vp, table, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_chunk(q[:, :, :, None], kp, vp, table, 3, 8)
    # the dispatchers take the plain versions for CPU tensors
    assert paged_decode_attention_lse(q, kp, vp, table, 3, 8)[0].shape == q.shape
    assert paged_chunk_attention(q[:, :, :, None], kp, vp, table, 3,
                                 8).shape == q[:, :, :, None].shape


# -- the kernel entries' signatures: reference-shaped positional calls -------------


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["paged_flash_decode_lse", "paged_flash_decode",
                                  "paged_flash_chunk"])
def test_kernel_signature_matches_reference(name):
    """Names, order and defaults, ``interpret`` last, as the reference's."""
    port = importlib.import_module("elephas_tpu_torch.ops.paged_attention")
    assert _params(getattr(port, name)) == _params(getattr(jax_pa, name))


@pytest.mark.parametrize("window", [None, 11])
def test_decode_positional_interpret_matches_pallas_kernel(window):
    """``paged_flash_decode_lse(q, kp, vp, table, pos, page, window,
    interpret)`` by position: the port's kernel entry takes the call and
    refuses the CPU tensors (no ``TypeError``); the dispatcher's result
    equals the reference's Pallas kernel run in interpret mode, at the
    reference tests' tolerance (rtol 2e-5, atol 2e-6)."""
    q, kp, vp, table = _setup(8, seed=21)
    pos = np.asarray([7, 12, 31], np.int32)
    jo, jl = jax_pa.paged_flash_decode_lse(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos)), 8, window, True)
    jo2 = jax_pa.paged_flash_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos)), 8, window, True)
    tq, tkp, tvp, ttable, tpos = _t(q, kp, vp, table, pos)
    for fn in (paged_flash_decode_lse, paged_flash_decode):
        with pytest.raises(ValueError, match="CUDA"):
            fn(tq, tkp, tvp, ttable, tpos, 8, window, True)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_decode_lse(tq, tkp, tvp, ttable, tpos, 8, window, interpret=False)
    o, lse = paged_decode_attention_lse(tq, tkp, tvp, ttable, tpos, 8, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo2), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("window", [None, 9])
def test_chunk_positional_interpret_matches_pallas_kernel(window):
    """``paged_flash_chunk(q, kp, vp, table, pos0, page, window, interpret)``
    by position, as the decode entry above."""
    q, kp, vp, table = _setup(8, seed=22, C=4)
    pos0 = np.asarray([6, 13, 22], np.int32)
    want = jax_pa.paged_flash_chunk(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos0)), 8, window, True)
    tq, tkp, tvp, ttable, tpos = _t(q, kp, vp, table, pos0)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_chunk(tq, tkp, tvp, ttable, tpos, 8, window, True)
    got = paged_chunk_attention(tq, tkp, tvp, ttable, tpos, 8, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


# -- the model's paged methods ---------------------------------------------------

CFG = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=64)
PAGE = 8


def _pools(model, B, M_, fill=7.25):
    """Dense cache, the pool (trash page 0 of finite garbage) and a table
    giving slot b the pages 1 + b*M_ .. (b+1)*M_."""
    L, hkv, dh = model.n_layers, model.n_kv_heads, model.d_model // model.n_heads
    cache = {k: torch.zeros((L, B, hkv, M_ * PAGE, dh)) for k in ("k", "v")}
    pool = {k: torch.full((L, B * M_ + 1, hkv, PAGE, dh), fill)
            for k in ("k", "v")}
    table = torch.from_numpy(
        (1 + np.arange(B * M_)).reshape(B, M_).astype(np.int32))
    return cache, pool, table


@pytest.mark.parametrize("kw", [{}, dict(pos_encoding="rotary", n_kv_heads=2,
                                         activation="swiglu", norm="rmsnorm")])
def test_paged_methods_bitwise_equal_dense(kw):
    """A chunk at 0 then eight single steps (across a page edge), and a
    per-row chunk at uneven positions: logits and written K/V equal the
    dense path's bit for bit."""
    model = TransformerLM(**CFG, **kw, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(0)
    B, M_ = 3, 8
    cache, pool, table = _pools(model, B, M_)
    toks = torch.from_numpy(rng.integers(0, 17, (B, 11)))
    lg_d, _ = model.decode_chunk(params, toks, 0, cache)
    lg_p, _ = model.decode_chunk_paged(params, toks, 0, pool, table, PAGE)
    assert torch.equal(lg_d, lg_p)
    for key in ("k", "v"):
        for l in range(model.n_layers):
            view = paged_view_rows(pool[key][l], table, PAGE)
            assert torch.equal(cache[key][l][:, :, :11], view[:, :, :11])
    pos = torch.full((B,), 11, dtype=torch.int64)
    for step in range(8):
        tok = torch.from_numpy(rng.integers(0, 17, (B,)))
        lg_d, _ = model.decode_step(params, tok, pos, cache)
        lg_p, _ = model.decode_step_paged(params, tok, pos, pool, table, PAGE)
        assert torch.equal(lg_d, lg_p), step
        pos = pos + 1
    pos0 = torch.tensor([19, 12, 16])
    ch = torch.from_numpy(rng.integers(0, 17, (B, 5)))
    lg_d, _ = model.decode_chunk(params, ch, pos0, cache)
    lg_p, _ = model.decode_chunk_paged(params, ch, pos0, pool, table, PAGE)
    assert torch.equal(lg_d, lg_p)


def test_unmapped_write_lands_in_trash():
    """Positions past the table's capacity write into page 0 and never touch
    a mapped page."""
    model = TransformerLM(**CFG, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(2)
    B, M_ = 3, 6
    _, pool, table = _pools(model, B, M_)
    toks = torch.from_numpy(rng.integers(0, 17, (B, 9)))
    model.decode_chunk_paged(params, toks, 0, pool, table, PAGE)
    before = {k: v.clone() for k, v in pool.items()}
    tok = torch.from_numpy(rng.integers(0, 17, (B,)))
    model.decode_step_paged(params, tok, torch.full((B,), 20), pool,
                            table[:, :2].contiguous(), PAGE)   # capacity 16
    for key in ("k", "v"):
        assert torch.equal(pool[key][:, 1:], before[key][:, 1:])
        assert not torch.equal(pool[key][:, 0], before[key][:, 0])


def test_decode_step_paged_matches_jax():
    """Same weights, pool and table in both packages: a chunk then two steps
    of ``decode_step_paged``, logits within 1e-5."""
    jm = JaxLM(**CFG, n_kv_heads=2)
    np_params = jm.init(3)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    model = TransformerLM(**CFG, n_kv_heads=2, device="cpu")
    params = from_jax_params(np_params, device="cpu")
    rng = np.random.default_rng(4)
    B, M_ = 3, 6
    _, pool, table = _pools(model, B, M_)
    jpool = {k: jnp.asarray(v.numpy()) for k, v in pool.items()}
    jtable = jnp.asarray(table.numpy())
    toks = rng.integers(0, 17, (B, 10)).astype(np.int32)
    _, jpool = jm.decode_chunk_paged(jparams, jnp.asarray(toks), 0, jpool,
                                     jtable, PAGE)
    model.decode_chunk_paged(params, torch.from_numpy(toks).long(), 0, pool,
                             table, PAGE)
    pos = np.array([10, 10, 10], np.int32)
    for _ in range(2):
        tok = rng.integers(0, 17, (B,)).astype(np.int32)
        jl, jpool = jm.decode_step_paged(jparams, jnp.asarray(tok),
                                         jnp.asarray(pos), jpool, jtable, PAGE)
        tl, _ = model.decode_step_paged(params, torch.from_numpy(tok).long(),
                                        torch.from_numpy(pos), pool, table,
                                        PAGE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        pos = pos + 1


# -- K5-decode's split rule, and its arithmetic emulated on the CPU ---------------


@pytest.mark.parametrize("page", [1, 4, 16, 64])
@pytest.mark.parametrize("window", [None, 1, 7, 40])
def test_decode_pieces_cover_the_visible_range_once(page, window):
    """For every position of a 256-row table and 1 to 9 splits: the pieces
    are contiguous in split order from ``lo`` to ``p`` (each row once),
    each non-empty one starts on a unit boundary counted from ``lo``, and
    their lengths differ by at most one unit of ``min(16, page)`` rows."""
    T, A = 256, min(16, page)
    for n_split in range(1, 10):
        for pos in range(T + 3):
            pieces = decode_pieces(pos, T, n_split, page, window)
            p = min(pos, T - 1)
            lo = 0 if window is None else max(0, p - window + 1)
            assert len(pieces) == n_split
            assert pieces[0][0] == lo and pieces[-1][1] == p + 1
            rows = [r for a, b in pieces for r in range(a, b)]
            assert rows == list(range(lo, p + 1))
            lengths = [b - a for a, b in pieces]
            assert max(lengths) - min(lengths) <= A
            assert all((a - lo) % A == 0 for a, b in pieces if b > a)


def test_splits_follow_the_grid_not_the_cache_length():
    """``n_split`` is about four blocks an SM for S * Hkv (KV head, slot)
    pairs, capped only so that a full cache's pieces are at least 16 rows."""
    assert _splits(8, 12, 1024, 132) == 6
    assert _splits(8, 12, 64, 132) == 4
    assert _splits(1, 1, 100000, 132) == 528
    assert _splits(64, 32, 1024, 132) == 1


def _emulated_decode(q, kp, vp, table, pos, page, window, n_split, bt):
    """K5-decode's arithmetic in plain PyTorch: each split's piece (from
    ``decode_pieces``) walked in tiles of ``bt`` rows with an online softmax
    (running max m, denominator l, unnormalised accumulator), then the
    combine: M = max over non-empty splits, L = sum l_i exp(m_i - M),
    out = sum exp(m_i - M) acc_i / L, lse = M + log L."""
    k, v = paged_view_rows(kp, table, page), paged_view_rows(vp, table, page)
    S_, Hkv_, G_, Dh_ = q.shape
    T = k.shape[2]
    scale = Dh_ ** -0.5
    out = torch.empty(S_, Hkv_, G_, Dh_)
    lse = torch.empty(S_, Hkv_, G_)
    for s in range(S_):
        parts = []
        for a, b in decode_pieces(int(pos[s]), T, n_split, page, window):
            m = torch.full((Hkv_, G_), -torch.inf)
            l_ = torch.zeros(Hkv_, G_)
            acc = torch.zeros(Hkv_, G_, Dh_)
            for t0 in range(a, b, bt):
                kt, vt = k[s, :, t0:min(b, t0 + bt)], v[s, :, t0:min(b, t0 + bt)]
                sc = torch.einsum("hgd,hjd->hgj", q[s], kt) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                pr = torch.exp(sc - m_new[..., None])
                l_ = alpha * l_ + pr.sum(-1)
                acc = alpha[..., None] * acc + torch.einsum("hgj,hjd->hgd", pr, vt)
                m = m_new
            parts.append((m, l_, acc))
        M = torch.stack([m for m, l_, _ in parts]).amax(0)
        w = [torch.where(l_ > 0, torch.exp(m - M), torch.zeros(())) for m, l_, _ in parts]
        L = sum(wi * l_ for wi, (_, l_, _) in zip(w, parts))
        out[s] = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, parts)) / L[..., None]
        lse[s] = M + torch.log(L)
    return out, lse


@pytest.mark.parametrize("page,M_", [(4, 16), (16, 4)])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("n_split", [3, 6])
def test_split_rule_emulation_matches_plain_at_every_position(page, M_, window, g, n_split):
    """The emulated kernel (per-split online softmax over 32-row tiles, then
    the combine) against ``paged_decode_reference_lse`` at atol = rtol =
    2e-5, one slot at each position 0 .. T-1 of a 64-row table."""
    T = page * M_
    rng = np.random.default_rng(page * 10 + g)
    P = T * M_ + 1
    kp = torch.from_numpy(rng.standard_normal((P, 2, page, 32)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, 2, page, 32)).astype(np.float32))
    kp[0] = vp[0] = 1e4
    table = torch.from_numpy((1 + rng.permutation(T * M_)).reshape(T, M_).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((T, 2, g, 32)).astype(np.float32))
    pos = torch.arange(T, dtype=torch.int32)
    for s in range(T):
        table[s, s // page + 1:] = 0   # unmapped past the slot's position
    got = _emulated_decode(q, kp, vp, table, pos, page, window, n_split, 32)
    want = paged_decode_reference_lse(q, kp, vp, table, pos, page, window)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)
