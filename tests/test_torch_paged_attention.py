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
- K5-chunk's tensor-core arithmetic (16-row blocks position-major across
  the group, 8 or 2 warps sharing each key stage, 3xTF32 products with a
  fresh sum per tile, the warps' merge) emulated against the plain version
  and the JAX kernel in interpret mode at the float32 pin, with one TF32
  product missing it and a bf16 pool's two products holding it.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
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
from tests.test_torch_flash_tf32x3 import _split

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
    their lengths differ by at most one unit of ``min(16, page)`` rows.
    ``p`` is ``pos`` clipped to the table and ``lo`` comes from the
    unclipped ``pos``, as the plain version's mask has it (past the table
    a window may leave nothing)."""
    T, A = 256, min(16, page)
    for n_split in range(1, 10):
        for pos in range(T + 3):
            pieces = decode_pieces(pos, T, n_split, page, window)
            p = min(pos, T - 1)
            lo = 0 if window is None else max(0, pos - window + 1)
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


def _tile_grid(pieces, bt, width=None, warps=1):
    """Row indices ``[R, P * warps, nt, width]`` and their validity for R
    rows' pieces (``P`` a row) walked in ``bt``-row tiles, warp ``w``
    taking rows ``w * width .. (w + 1) * width`` of each tile (``width``
    ``bt`` without warps); ``nt`` the most tiles any piece has."""
    width = bt if width is None else width
    a = torch.tensor([[lo for lo, _ in row] for row in pieces])          # [R, P]
    b = torch.tensor([[hi for _, hi in row] for row in pieces])
    nt = max(1, int((-(-(b - a) // bt)).max()))
    j = (a[:, :, None, None, None] + torch.arange(warps)[:, None, None] * width
         + torch.arange(nt)[:, None] * bt + torch.arange(width))          # [R, P, W, nt, w]
    valid = j < b[:, :, None, None, None]
    R, P = a.shape
    return j.reshape(R, P * warps, nt, width), valid.reshape(R, P * warps, nt, width)


def _online_softmax(q, k, v, j, valid, scale):
    """Each lane's online softmax over its tiles, all lanes at once: q
    ``[R, H, G, D]``, k and v ``[R, H, T, D]``, ``j`` / ``valid`` ``[R, L,
    nt, w]`` (rows of k, their validity) → per lane (m, l, acc). A tile
    with no valid row leaves its lane as it was (the kernel skips it)."""
    R, H, G, D = q.shape
    L_, nt = j.shape[1], j.shape[2]
    kr, vr = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)                 # [R, T, H, D]
    ar = torch.arange(R)[:, None, None]
    m = torch.full((R, L_, H, G), -torch.inf)
    l_ = torch.zeros(R, L_, H, G)
    acc = torch.zeros(R, L_, H, G, D)
    for t in range(nt):
        jt, ok = j[:, :, t].clamp(0, k.shape[2] - 1), valid[:, :, t]      # [R, L, w]
        kt = kr[ar, jt].permute(0, 1, 3, 2, 4)                             # [R, L, H, w, D]
        vt = vr[ar, jt].permute(0, 1, 3, 2, 4)
        sc = torch.einsum("rhgd,rlhjd->rlhgj", q, kt) * scale
        sc = sc.masked_fill(~ok[:, :, None, None, :], -torch.inf)
        any_ = ok.any(-1)[:, :, None, None]
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.where(any_, torch.exp(m - m_new), 1.0)
        pr = torch.where(ok[:, :, None, None, :], torch.exp(sc - m_new[..., None]), 0.0)
        l_ = alpha * l_ + pr.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum("rlhgj,rlhjd->rlhgd", pr, vt)
        m = m_new
    return m, l_, acc


def _combine(m, l_, acc):
    """The splits' combine over lane axis 1: M = max over non-empty splits,
    L = sum l_i exp(m_i - M), out = sum exp(m_i - M) acc_i / L, lse = M +
    log L."""
    M = m.amax(1)
    w = torch.where(l_ > 0, torch.exp(m - M[:, None]), torch.zeros(()))
    L = (w * l_).sum(1)
    return (w[..., None] * acc).sum(1) / L[..., None], M + torch.log(L)


def _emulated_decode(q, kp, vp, table, pos, page, window, n_split, bt):
    """K5-decode's arithmetic in plain PyTorch: each split's piece (from
    ``decode_pieces``) walked in tiles of ``bt`` rows with an online softmax
    (running max m, denominator l, unnormalised accumulator), then the
    combine: M = max over non-empty splits, L = sum l_i exp(m_i - M),
    out = sum exp(m_i - M) acc_i / L, lse = M + log L. Every slot's every
    split runs as one lane of :func:`_online_softmax`."""
    k, v = paged_view_rows(kp, table, page), paged_view_rows(vp, table, page)
    T = k.shape[2]
    pieces = [decode_pieces(int(p), T, n_split, page, window) for p in pos]
    j, valid = _tile_grid(pieces, bt)
    return _combine(*_online_softmax(q, k, v, j, valid, q.shape[-1] ** -0.5))


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


# -- K5-chunk's tensor-core arithmetic emulated on the CPU -------------------------


def _emulated_chunk(q, kp, vp, table, pos0, page, window, passes, warps=8, bk=8):
    """K5-chunk's arithmetic in plain PyTorch: blocks of 16 query rows taken
    position-major across the G heads (row ``i`` is ``(c, g) = (i // G, i %
    G)``), their rows' key range cut into stages of ``warps * bk`` rows;
    warp ``w`` takes the ``w``-th ``bk`` keys of every stage with its own
    online softmax, s = q.k^T and each tile's p.v as TF32 products
    (``passes`` 3: 3xTF32, 2: a B exact in TF32, as a widened bf16, 1: one
    TF32 product), p.v in a fresh sum added once; the warps' (m, l, o)
    merged in warp order, then o / l (0 for a row that sees no key)."""
    k = paged_view_rows(kp, table, page).float()
    v = paged_view_rows(vp, table, page).float()
    S_, Hkv_, G_, C, Dh_ = q.shape
    cap, R, bs = k.shape[2], G_ * C, warps * bk
    scale = Dh_ ** -0.5

    def mul(eq, a, b):
        ab, as_ = _split(a)
        bb, bs_ = _split(b)
        out = torch.einsum(eq, ab, bb)
        if passes >= 2:
            out = torch.einsum(eq, as_, bb) + out
        if passes == 3:
            out = torch.einsum(eq, ab, bs_) + out
        return out

    def merge(parts):   # [(m, l, o)] -> (M, L, O), in order
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        wt = [torch.where(m > -torch.inf, torch.exp(m - M), 0.0) for m, _, _ in parts]
        return (M, sum(x * l_ for x, (_, l_, _) in zip(wt, parts)),
                sum(x[..., None] * o for x, (_, _, o) in zip(wt, parts)))

    out = torch.zeros(S_, Hkv_, G_, C, Dh_)
    lane = torch.arange(warps)[:, None] * bk + torch.arange(bk)     # [warps, bk]
    for s in range(S_):
        p0 = int(pos0[s])
        for r0 in range(0, R, 16):
            i = torch.arange(r0, min(r0 + 16, R))
            c, g = i // G_, i % G_
            qp = p0 + c                                   # the rows' positions
            k_hi = min(int(qp[-1]) + 1, cap)
            k_lo = 0 if window is None else max(0, int(qp[0]) - window + 1)
            n_st = max(0, -(-(k_hi - k_lo) // bs))
            qr = q[s][:, g, c][None].expand(warps, -1, -1, -1)   # [warps, Hkv, rows, Dh]
            # every warp's online softmax at once; a warp without keys in a
            # stage leaves its (m, l, o) as they were (the kernel skips it)
            m = torch.full((warps, Hkv_, len(i)), -torch.inf)
            l_ = torch.zeros(warps, Hkv_, len(i))
            acc = torch.zeros(warps, Hkv_, len(i), Dh_)
            for st in range(n_st):
                j = k_lo + st * bs + lane                 # [warps, bk]
                ok = j < k_hi
                jc = j.clamp(max=cap - 1)
                kt = k[s][:, jc].permute(1, 0, 2, 3)      # [warps, Hkv, bk, Dh]
                vt = v[s][:, jc].permute(1, 0, 2, 3)
                sc = mul("whnd,whjd->whnj", qr, kt) * scale
                vis = ok[:, None, :] & (j[:, None, :] <= qp[None, :, None])
                if window is not None:
                    vis &= j[:, None, :] > qp[None, :, None] - window
                sc = sc.masked_fill(~vis[:, None], -torch.inf)
                mx = torch.maximum(m, sc.amax(-1))
                seen = mx > -torch.inf
                pr = torch.where(seen[..., None] & vis[:, None],
                                 torch.exp(sc - mx[..., None]), 0.0)
                alpha = torch.where(seen, torch.exp(m - mx), 1.0)
                l_ = alpha * l_ + pr.sum(-1)
                acc = alpha[..., None] * acc + mul("whnj,whjd->whnd", pr, vt)
                m = mx
            _, L, O = merge(list(zip(m, l_, acc)))
            out[s][:, g, c] = torch.where(L[..., None] > 0, O * (1 / L[..., None]), 0.0)
    return out


def _chunk_case(page, g, C, seed, bf16=False):
    """q, pools (trash page 0 at 1e4), a 192-row table scattered and left
    unmapped past each slot's chunk, and per-slot ``pos0`` (an empty prefix,
    a straddled page edge, the table's end: up to 192 keys)."""
    rng = np.random.default_rng(seed)
    S_, M_, hkv, dh = 3, 192 // page, 2, 32
    P = S_ * M_ + 1
    kp = rng.standard_normal((P, hkv, page, dh)).astype(np.float32)
    vp = rng.standard_normal((P, hkv, page, dh)).astype(np.float32)
    kp[0] = vp[0] = 1e4
    if bf16:   # values a bf16 pool holds, kept in float32
        kp, vp = (torch.from_numpy(a).bfloat16().float().numpy() for a in (kp, vp))
    table = (1 + rng.permutation(S_ * M_)).reshape(S_, M_).astype(np.int32)
    pos0 = np.array([0, page + 3, 192 - C], np.int32)
    for s, p in enumerate(pos0 + C - 1):
        table[s, p // page + 1:] = 0
    q = rng.standard_normal((S_, hkv, g, C, dh)).astype(np.float32)
    return q, kp, vp, table, pos0


_PALLAS_CHUNKS = {}


def _pallas_chunk(page, g, window, *arrays):
    """The JAX ``paged_flash_chunk`` in interpret mode on one case, run once
    per (page, g, window): both warp counts compare with the same output."""
    key = (page, g, window)
    if key not in _PALLAS_CHUNKS:
        _PALLAS_CHUNKS[key] = np.asarray(jax_pa.paged_flash_chunk(
            *(jnp.asarray(a) for a in arrays), page, window, True))
    return _PALLAS_CHUNKS[key]


@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("warps", [8, 2])
def test_chunk_tf32x3_emulation_matches_plain_and_pallas(page, g, window, warps):
    """The emulated K5-chunk in float32 (3xTF32, 16-row blocks across the
    group, 8 or 2 warps of 8 keys a stage: the kernel's head-dim classes up
    to 64 and 256) against ``paged_chunk_reference`` and the JAX
    ``paged_flash_chunk`` in interpret mode, both at atol = rtol = 2e-5
    (the float32 pin); one TF32 product misses the pin."""
    q, kp, vp, table, pos0 = _chunk_case(page, g, 20, 30 + page + g)
    args = _t(q, kp, vp, table, pos0)
    got = _emulated_chunk(*args, page, window, passes=3, warps=warps)
    torch.testing.assert_close(got, paged_chunk_reference(*args, page, window),
                               atol=2e-5, rtol=2e-5)
    want = _pallas_chunk(page, g, window, q, kp, vp, table, pos0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    one = _emulated_chunk(*args, page, window, passes=1, warps=warps)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, paged_chunk_reference(*args, page, window),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("g", [1, 4])
def test_chunk_bf16_pool_two_products_hold_the_float32_pin(g):
    """A bf16 pool is exact in TF32, so K5-chunk runs its products as two
    TF32 ones (q's and p's small parts against K's and V's only part): the
    emulation holds the float32-widened plain version at atol = rtol =
    2e-5."""
    q, kp, vp, table, pos0 = _chunk_case(8, g, 24, 40 + g, bf16=True)
    args = _t(q, kp, vp, table, pos0)
    got = _emulated_chunk(*args, 8, None, passes=2)
    torch.testing.assert_close(got, paged_chunk_reference(*args, 8), atol=2e-5, rtol=2e-5)
