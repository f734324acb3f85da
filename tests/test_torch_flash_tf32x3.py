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
"""

import numpy as np
import pytest
import torch

from elephas_tpu_torch.ops.flash_attention import (attention_bwd_reference,
                                                   attention_fwd_reference,
                                                   repeat_kv_heads)

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


@pytest.mark.parametrize("B,T,H,Hkv,Dh,causal,window", [
    (1, 37, 8, 2, 64, True, None),        # GQA, T shorter than a tile
    (1, 100, 8, 2, 128, True, None),      # the Dh-128 class, ragged T
    (2, 70, 8, 2, 64, True, 16),          # a window
    (1, 45, 8, 2, 128, True, 9),          # a window at Dh 128
    (1, 33, 8, 2, 64, False, None),       # non-causal
])
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
