"""The arithmetic contract of the tensor-core K2 backward (K2-dq and K2-dkv in
``elephas_tpu_torch/ops/csrc/flash_attention.cu``), emulated on the CPU.

float32 inputs run as 3xTF32: each operand ``x`` is split into ``big =
tf32(x)`` and ``small = tf32(x - big)`` (``cvt.rna.tf32.f32``: round the
float32 bits to nearest, ties away from zero, then clear the low 13
mantissa bits), and every product is ``small*big' + big*small' +
big*big'`` summed in float32. Here every one of the five products of the
FlashAttention-2 backward (``s = q.k^T``, ``dp = dO.v^T``, ``dv = p^T.dO``,
``dq = ds.k``, ``dk = ds^T.q``) is emulated that way, and the gradients are
held to the K2 float32 pin (atol = rtol = 2e-5, the reference's own for its
kernels) against the plain float32 version. A single TF32 product
(``big*big'`` alone) must miss that pin, so the test can fail. bf16 inputs
run bf16 products with ``p`` and ``ds`` rounded to bf16 before the second
products, as the reference's Pallas kernels round them: that stays within
the bf16 pin (2e-2) of the plain version, which keeps them in float32.

The tensor-core K2-fwd is emulated the same way (``emulated_fwd``): the
online softmax over BK-row KV tiles, ``s = q.k^T`` and each tile's ``p.v``
as 3xTF32 products, o rescaled by ``alpha = exp(m_old - m_new)`` before the
tile's ``p.v`` is added once; o and lse are held to the same float32 pin,
with and without rope on load. bf16 rounds ``p`` to bf16 only for ``p.v``
(the reference's ``p.astype(v.dtype)``) while ``l`` sums it unrounded.
"""

import numpy as np
import pytest
import torch

from elephas_tpu_torch.ops.flash_attention import (_rope_apply, _visible,
                                                   attention_bwd_reference,
                                                   attention_fwd_reference,
                                                   make_rope_tables,
                                                   repeat_kv_heads,
                                                   rope_attention_fwd_reference)

TOL = dict(atol=2e-5, rtol=2e-5)


def tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to TF32 (10 mantissa bits),
    to nearest with ties away from zero, as float32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _split(x):
    big = tf32(x)
    return big, tf32(x - big)


def product(eq, a, b, passes):
    """``einsum(eq, a, b)`` of float32 operands as the tensor cores compute
    it: ``passes=3`` is 3xTF32, ``passes=1`` one TF32 product. A product of
    two TF32 values is exact in float32; the sums are float32."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    out = torch.einsum(eq, ab, bb)
    if passes == 3:
        out = torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs) + out
    return out


def emulated_bwd(q, k, v, do, lse, delta, causal, window, passes):
    """``attention_bwd_reference``'s float32 math with every product
    emulated: ``(dq, dk, dv)`` in float32."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    kr, vr = repeat_kv_heads(k, H), repeat_kv_heads(v, H)
    s = product("bqhd,bkhd->bhqk", q, kr, passes) * Dh ** -0.5
    if causal:
        i = torch.arange(T)[:, None]
        j = torch.arange(T)[None, :]
        keep = j <= i
        if window is not None:
            keep = keep & (j > i - window)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dv = product("bhqk,bqhd->bkhd", p, do, passes)
    dp = product("bqhd,bkhd->bhqk", do, vr, passes)
    ds = p * (dp - delta[..., None]) * Dh ** -0.5
    dq = product("bhqk,bkhd->bqhd", ds, kr, passes)
    dk = product("bhqk,bqhd->bkhd", ds, q, passes)
    if Hkv != H:
        dk = dk.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)
        dv = dv.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)
    return dq, dk, dv


def emulated_fwd(q, k, v, causal, window, passes, bk=64, round_p=False):
    """The tensor-core K2-fwd's arithmetic on ``bk``-row KV tiles: ``(o
    [B, T, H, Dh], lse [B, H, T])`` in float32. ``passes`` 3 or 1 emulates
    3xTF32 or one TF32 product; ``None`` takes the products exact in
    float32 (bf16 inputs). ``round_p`` rounds p to bf16 for ``p.v`` only."""
    B, T, H, Dh = q.shape

    def mul(eq, a, b):
        return torch.einsum(eq, a, b) if passes is None else product(eq, a, b, passes)

    qf = q.float()
    kr, vr = repeat_kv_heads(k, H).float(), repeat_kv_heads(v, H).float()
    keep = _visible(T, T, causal, window, q.device)
    m = torch.full((B, H, T), float("-inf"))
    l = torch.zeros(B, H, T)
    o = torch.zeros(B, H, T, Dh)
    for k0 in range(0, T, bk):
        s = mul("bqhd,bkhd->bhqk", qf, kr[:, k0:k0 + bk]) * Dh ** -0.5
        if keep is not None:
            s = s.masked_fill(~keep[:, k0:k0 + bk], float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        seen = mx > float("-inf")
        p = torch.where(seen[..., None], torch.exp(s - mx[..., None]), 0.0)
        alpha = torch.where(seen, torch.exp(m - mx), 1.0)
        l = alpha * l + p.sum(-1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + mul("bhqk,bkhd->bhqd", p, vr[:, k0:k0 + bk])
        m = mx
    return (o / l[..., None]).transpose(1, 2), m + torch.log(l)


def _inputs(seed, B, T, H, Hkv, Dh, causal, window):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(B, T, H, Dh)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, T, Hkv, Dh)).astype(np.float32))
            for _ in range(2))
    o, lse = attention_fwd_reference(q, k, v, causal, window)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def test_tf32_rounds_to_nearest_ties_away_and_keeps_ten_bits():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    assert (tf32(y).view(torch.int32) & 0x1FFF).eq(0).all()
    big, small = _split(y)
    assert ((big + small - y).abs() <= 2.0 ** -21 * y.abs()).all()


SHAPES = [
    (1, 37, 8, 2, 64, True, None),        # GQA, T shorter than a tile
    (1, 100, 8, 2, 128, True, None),      # the Dh-128 class, ragged T
    (2, 70, 8, 2, 64, True, 16),          # a window
    (1, 45, 8, 2, 128, True, 9),          # a window at Dh 128
    (1, 33, 8, 2, 64, False, None),       # non-causal
]


@pytest.mark.parametrize("B,T,H,Hkv,Dh,causal,window", SHAPES)
def test_3xtf32_backward_holds_the_float32_pin(B, T, H, Hkv, Dh, causal, window):
    """Every product of the backward as 3xTF32 stays within atol = rtol =
    2e-5 of the plain float32 version; one TF32 product does not."""
    args = _inputs(7, B, T, H, Hkv, Dh, causal, window)
    want = attention_bwd_reference(*args, causal, window)
    got = emulated_bwd(*args, causal, window, passes=3)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, **TOL, msg=name)
    single = emulated_bwd(*args, causal, window, passes=1)
    assert not all(torch.allclose(a, w, **TOL) for a, w in zip(single, want))


def test_bf16_p_and_ds_rounded_stay_within_the_bf16_pin():
    """bf16 inputs: the products are exact in float32, and rounding p and
    ds to bf16 before dv, dk and dq (the Pallas kernels' ``astype``) keeps
    the gradients within 2e-2 of the plain version, which does not round
    them; the rounding does change the result."""
    B, T, H, Hkv, Dh = 1, 60, 8, 2, 64
    q, k, v, do, lse, delta = _inputs(8, B, T, H, Hkv, Dh, True, None)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    want = attention_bwd_reference(q, k, v, do, lse, delta, True)
    f = [t.float() for t in (q, k, v, do)]
    kr, vr = repeat_kv_heads(f[1], H), repeat_kv_heads(f[2], H)
    s = torch.einsum("bqhd,bkhd->bhqk", f[0], kr) * Dh ** -0.5
    keep = torch.arange(T)[None, :] <= torch.arange(T)[:, None]
    p = torch.exp(s.masked_fill(~keep, float("-inf")) - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", f[3], vr) - delta[..., None]) * Dh ** -0.5
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    got = (torch.einsum("bhqk,bkhd->bqhd", dsb, kr),
           torch.einsum("bhqk,bqhd->bkhd", dsb, f[0]).reshape(B, T, Hkv, H // Hkv, Dh).sum(3),
           torch.einsum("bhqk,bqhd->bkhd", pb, f[3]).reshape(B, T, Hkv, H // Hkv, Dh).sum(3))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.to(torch.bfloat16).float(), w.float(), atol=2e-2,
                                   rtol=2e-2, msg=name)
    assert any(not torch.equal(a.to(torch.bfloat16), w) for a, w in zip(got, want))


def _fwd_bk(Dh):
    """The forward's KV tile rows for a head dim (``FwdClass`` in the
    source: 64 up to Dh 64, 32 above)."""
    return 64 if Dh <= 64 else 32


@pytest.mark.parametrize("B,T,H,Hkv,Dh,causal,window", SHAPES)
def test_3xtf32_forward_holds_the_float32_pin(B, T, H, Hkv, Dh, causal, window):
    """The forward's online softmax with s and p.v as 3xTF32 keeps o and
    lse within atol = rtol = 2e-5 of the plain float32 version; one TF32
    product does not."""
    q, k, v = _inputs(5, B, T, H, Hkv, Dh, causal, window)[:3]
    want = attention_fwd_reference(q, k, v, causal, window)
    got = emulated_fwd(q, k, v, causal, window, passes=3, bk=_fwd_bk(Dh))
    for name, a, w in zip(("o", "lse"), got, want):
        torch.testing.assert_close(a, w, **TOL, msg=name)
    single = emulated_fwd(q, k, v, causal, window, passes=1, bk=_fwd_bk(Dh))
    assert not all(torch.allclose(a, w, **TOL) for a, w in zip(single, want))


def test_3xtf32_rope_forward_holds_the_float32_pin():
    """Rope on load: q and k rotated as ``rope_attention_fwd_reference``
    rotates them (its tables, Llama-3's theta), then the emulated forward:
    the same pin, and one TF32 product misses it."""
    B, T, H, Hkv, Dh = 2, 90, 8, 2, 128
    q, k, v = _inputs(6, B, T, H, Hkv, Dh, True, None)[:3]
    pos = 11 + 37 * np.arange(B)[:, None] + np.arange(T)[None, :]
    ang = pos[..., None] * 500000.0 ** (-np.arange(0, Dh, 2) / Dh)
    c2, s2 = make_rope_tables(torch.from_numpy(np.cos(ang)).float(),
                              torch.from_numpy(np.sin(ang)).float())
    want = rope_attention_fwd_reference(q, k, v, c2, s2, True)
    qr, kr = _rope_apply(q, c2, s2), _rope_apply(k, c2, s2)
    got = emulated_fwd(qr, kr, v, True, None, passes=3, bk=_fwd_bk(Dh))
    for name, a, w in zip(("o", "lse"), got, want):
        torch.testing.assert_close(a, w, **TOL, msg=name)
    single = emulated_fwd(qr, kr, v, True, None, passes=1, bk=_fwd_bk(Dh))
    assert not all(torch.allclose(a, w, **TOL) for a, w in zip(single, want))


def test_bf16_forward_p_rounded_stays_within_the_bf16_pin():
    """bf16 inputs: p rounded to bf16 before p.v and l summed unrounded
    keeps o and lse within 2e-2 of the plain version, which keeps p in
    float32; the rounding does change o."""
    B, T, H, Hkv, Dh = 1, 150, 8, 2, 64
    q, k, v = (t.to(torch.bfloat16) for t in _inputs(9, B, T, H, Hkv, Dh, True, None)[:3])
    want = attention_fwd_reference(q, k, v, True)
    o, lse = emulated_fwd(q, k, v, True, None, passes=None, bk=_fwd_bk(Dh), round_p=True)
    o = o.to(torch.bfloat16)
    torch.testing.assert_close(o.float(), want[0].float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want[1], atol=2e-2, rtol=2e-2)
    assert not torch.equal(o, want[0])
