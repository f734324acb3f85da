"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving and training runs do not reach (scalar-load
head dims, odd group sizes, caches and sequences shorter than a tile,
every mask mode, pages smaller and larger than a key tile, grouped
products with empty experts, ragged K/N and wide tiles, loss rows on each
of K1's three routes and across their boundaries with zero and soft labels,
misaligned rows, masked slices of -inf logits and plans the kernels refuse, the flash-attention
kernels in every tile class at its edges in float32 and bf16 and their
bitwise determinism, the rope-on-load flash-attention kernels at the
Llama-3-8B training shape and its edges),
the wrappers' refusals, and the serving engine (dense and paged), the train step and
``generate`` on the card against the same code on the CPU, for the dense
and the mixture-of-experts LM, and the MLP fit's five schedules; the Keras
layers of the repo's examples (Conv2D, MaxPooling2D, Conv1D,
BatchNormalization, Reshape, Embedding, LSTM) and a BatchNormalization
CNN's fit on the card against the CPU, and the Embedding's range check;
the Spark-ML estimator's K1 launches and the search's pinning to a card;
multi-tenant LoRA serving (plain and speculative) and the LoRA train step
on the card against the merged oracles and the CPU.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import). This file imports no JAX, so it runs on a machine
with only PyTorch: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import numpy as np
import pytest
import torch

from elephas_tpu_torch.models import (MoETransformerLM, MultiTenantLM,
                                      TransformerLM, adam, adam_compact,
                                      apply_lora, build_lm_train_step,
                                      build_lora_lm_train_step, make_lm_batches)
from elephas_tpu_torch.models.transformer import _rope_angles
from elephas_tpu_torch.ops.flash_attention import (
    attention_bwd_reference, attention_fwd_reference, flash_attention,
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
    flash_attention_rope, flash_attention_rope_dkv, flash_attention_rope_dq,
    flash_attention_rope_fwd, make_rope_tables, rope_attention_bwd_reference,
    rope_attention_fwd_reference)
from elephas_tpu_torch.ops.flash_decode import (decode_attention_reference,
                                                decode_attention_reference_lse,
                                                flash_decode, flash_decode_lse)
from elephas_tpu_torch.ops.fused_xent import (categorical_crossentropy_from_logits,
                                              fused_xent_bwd, fused_xent_bwd_reference,
                                              fused_xent_from_logits, fused_xent_fwd,
                                              fused_xent_fwd_reference)
from elephas_tpu_torch.ops.grouped_matmul import (gmm, gmm_reference, gmm_t,
                                                  tgmm, tgmm_reference)
from elephas_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                              fused_layer_norm_bwd,
                                              layer_norm_reference)
from elephas_tpu_torch.ops.paged_attention import (
    paged_chunk_reference, paged_decode_reference_lse, paged_flash_chunk,
    paged_flash_decode_lse)
from elephas_tpu_torch.hyperparam import uniform  # noqa: F401  (the search's marker)
from elephas_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from elephas_tpu_torch import resolve_device

    return resolve_device("cuda")


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        "cuda", dtype)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (8, 768), (130, 4097),
                                   (2, 3, 256)])
def test_layer_norm_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    x = _t(rng, *shape) * 3 + 1
    s, b = _t(rng, shape[-1]), _t(rng, shape[-1])
    got = fused_layer_norm(x, s, b)
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, layer_norm_reference(x, s, b),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [1, 3, 127, 128, 129, 768, 1000, 1024, 1025, 4097])
@pytest.mark.parametrize("n", [1, 8, 8192])
def test_layer_norm_fwd_routes_match_plain(cuda, n, d):
    """K3-fwd on both routes (one warp a row up to D 1024, one block a row
    past it; float4 rows where D % 4 == 0, scalar ones at 1, 3, 127, 129,
    1025), against the plain version at atol = rtol = 1e-5, and the same
    bits from a second launch (a row's result depends on its warp alone)."""
    rng = np.random.default_rng(n * 10000 + d)
    x = _t(rng, n, d) * 3 + 1
    s, b = _t(rng, d), _t(rng, d)
    got = fused_layer_norm(x, s, b)
    torch.testing.assert_close(got, layer_norm_reference(x, s, b), atol=1e-5, rtol=1e-5)
    assert torch.equal(fused_layer_norm(x, s, b), got)


@pytest.mark.parametrize("d", [768, 1000])
def test_layer_norm_fwd_misaligned_rows_take_scalar_loads(cuda, d):
    """Rows that start 4 bytes past a 16-byte boundary (a contiguous view at
    an odd offset) take the scalar path although D % 4 == 0: the plain
    version's result at 1e-5, and the aligned copy's (float4 loads, the
    same sums over other lane columns) at 1e-6."""
    rng = np.random.default_rng(d)
    flat = _t(rng, 64 * d + 1) * 3 + 1
    x = flat[1:].view(64, d)
    assert x.data_ptr() % 16 != 0
    s, b = _t(rng, d), _t(rng, d)
    got = fused_layer_norm(x, s, b)
    torch.testing.assert_close(got, layer_norm_reference(x, s, b), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, fused_layer_norm(x.clone(), s, b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("d", [768, 1000, 1024, 1025])
def test_layer_norm_fwd_row_at_1e4_against_float64(cuda, d):
    """A row riding at 1e4 on both routes: the mean summed in double and x
    - mean formed in double keep K3-fwd within 1e-5 of the plain version
    run in float64."""
    rng = np.random.default_rng(7)
    x = _t(rng, 64, d) * 3 + 1
    x[0] += 1e4
    s, b = _t(rng, d), _t(rng, d)
    got = fused_layer_norm(x, s, b)
    want = layer_norm_reference(x.double(), s.double(), b.double())
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,hkv,g,dh,T", [
    (2, 3, 5, 6, 70),       # odd group, scalar loads (Dh % 4 != 0)
    (1, 1, 1, 128, 1),      # a one-slot cache
    (3, 2, 8, 32, 700),     # several splits, partial last tile
    (1, 4, 1, 64, 63),      # shorter than one tile
])
@pytest.mark.parametrize("mode", ["plain", "window", "ring"])
def test_flash_decode_kernel_matches_plain(cuda, B, hkv, g, dh, T, mode):
    rng = np.random.default_rng(1)
    q = _t(rng, B, hkv, g, dh)
    k, v = _t(rng, B, hkv, T, dh), _t(rng, B, hkv, T, dh)
    window = None if mode == "plain" else max(1, T // 3)
    ring = mode == "ring"
    top = 2 * T + 5 if ring else T - 1
    pos = torch.tensor(np.linspace(0, top, B).astype(np.int32), device="cuda")
    got = flash_decode_lse(q, k, v, pos, window=window, ring=ring)
    want = decode_attention_reference_lse(q, k, v, pos, window, ring)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_flash_decode_kernel_bf16_cache_and_scalar_pos(cuda):
    rng = np.random.default_rng(2)
    q = _t(rng, 4, 2, 2, 64)
    k = _t(rng, 4, 2, 300, 64, dtype=torch.bfloat16)
    v = _t(rng, 4, 2, 300, 64, dtype=torch.bfloat16)
    got = flash_decode_lse(q, k, v, 211)
    want = decode_attention_reference_lse(q, k, v, 211)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("mode", ["plain", "window", "ring", "window_past_T"])
@pytest.mark.parametrize("g,dh,dtype,tol", [(1, 64, torch.float32, 1e-5),
                                            (4, 128, torch.float32, 1e-5),
                                            (2, 64, torch.bfloat16, 2e-2)])
def test_flash_decode_every_position_matches_plain(cuda, mode, g, dh, dtype, tol):
    """K4 (pieces cut from ``pos`` on the device) at every position of a
    256-slot cache, 8 rows a launch: plain, a window of 40, a ring of window
    100 over positions 0 .. 2T-1, and a window of 40 at positions T .. T+38
    (a sequence-sharded rank's pos past its T); G 1 / Dh 64, G 4 / Dh 128
    and a bf16 cache. atol = rtol = 1e-5 in float32 (2e-2 bf16) against
    the plain version, and the same bits from a second launch."""
    T = 256
    window = None if mode == "plain" else 100 if mode == "ring" else 40
    ring = mode == "ring"
    positions = {"ring": np.arange(2 * T), "window_past_T": np.arange(T, T + 39)}.get(
        mode, np.arange(T))
    rng = np.random.default_rng(g * 10 + dh)
    for first in range(0, len(positions), 8):
        pos = positions[first:first + 8].astype(np.int32)
        B = len(pos)
        q = _t(rng, B, 2, g, dh)
        k, v = _t(rng, B, 2, T, dh, dtype=dtype), _t(rng, B, 2, T, dh, dtype=dtype)
        pos_t = torch.from_numpy(pos).cuda()
        got = flash_decode_lse(q, k, v, pos_t, window=window, ring=ring)
        want = decode_attention_reference_lse(q, k, v, pos_t, window, ring)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=tol, rtol=tol)
        for a, w in zip(flash_decode_lse(q, k, v, pos_t, window=window, ring=ring), got):
            assert torch.equal(a, w)


@pytest.mark.parametrize("B,hkv,g,dh,T,pos", [
    (8, 12, 1, 64, 1024, [31, 15, 16, 511, 512, 700, 1000, 1023]),      # GPT-2 decode
    (8, 8, 4, 128, 2048, [0, 31, 256, 700, 1023, 1500, 2000, 2047]),    # Mixtral widths
])
def test_flash_decode_main_path_shapes_match_plain(cuda, B, hkv, g, dh, T, pos):
    """K4 at the decode shapes ``serve`` and ``serve_moe`` run: atol = rtol =
    1e-5 against the plain version, the same bits twice."""
    rng = np.random.default_rng(B * hkv + g)
    q, k, v = _t(rng, B, hkv, g, dh), _t(rng, B, hkv, T, dh), _t(rng, B, hkv, T, dh)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    got = flash_decode_lse(q, k, v, pos_t)
    for a, w in zip(got, decode_attention_reference_lse(q, k, v, pos_t)):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
    for a, w in zip(flash_decode_lse(q, k, v, pos_t), got):
        assert torch.equal(a, w)


def test_kernel_wrappers_refuse_bad_input(cuda):
    rng = np.random.default_rng(3)
    q, k = _t(rng, 1, 1, 1, 8), _t(rng, 1, 1, 16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode_lse(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         k, 3)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_lse(_t(rng, 1, 1, 1, 256), _t(rng, 1, 1, 4, 256),
                         _t(rng, 1, 1, 4, 256), 1)
    with pytest.raises(ValueError, match="scale/bias"):
        fused_layer_norm(_t(rng, 2, 8), _t(rng, 7), _t(rng, 8))


def test_engine_on_card_matches_cpu_engine(cuda):
    cfg = dict(vocab=97, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_len=64, activation="gelu", attn_bias=True,
               tie_embeddings=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (3, 9, 17, 30)]
    out = {}
    for dev in ("cpu", "cuda"):
        model = TransformerLM(**cfg, device=dev)
        eng = ServingEngine(model, model.init(5), n_slots=2, device=dev)
        ids = [eng.submit(p, 12) for p in prompts]
        fin = eng.drain()
        out[dev] = [fin[i].tokens for i in ids]
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (130, 4097), (2, 3, 256),
                                   (1100, 64), (8, 1024), (37, 1025), (8, 1001),
                                   (1100, 768), (8193, 768), (1037, 1024)])
def test_layer_norm_bwd_kernel_matches_plain(cuda, shape):
    """K3-bwd against autograd through the plain version, atol/rtol 1e-4, on
    both routes: one warp a row up to D 1024 (the register limit; float4
    rows where D % 4 == 0, scalar ones at D 1001 and 5), one block a row
    past it (1025, 4097). (1100, 64) and (1100, 768) give each pass-1 block
    5 rows for its 4 warps; (8193, 768) 32 rows a block and one short."""
    rng = np.random.default_rng(5)
    x = _t(rng, *shape) * 3 + 1
    s, b, g = _t(rng, shape[-1]), _t(rng, shape[-1]), _t(rng, *shape)
    got = fused_layer_norm_bwd(x, s, g)
    args = [t.clone().requires_grad_() for t in (x, s, b)]
    want = torch.autograd.grad(layer_norm_reference(*args), args, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
    # deterministic: the same bits on a second run
    for a, w in zip(fused_layer_norm_bwd(x, s, g), got):
        assert torch.equal(a, w)


@pytest.mark.parametrize("d", [768, 1024, 2048])
def test_layer_norm_bwd_row_at_1e4_against_float64(cuda, d):
    """A row riding at 1e4 on both routes: the row mean is summed in double
    and x - mean formed in double, so K3-bwd stays within 1e-4 of the plain
    version run in float64 (a float32 row mean rounds visibly there)."""
    rng = np.random.default_rng(6)
    x = _t(rng, 64, d) * 3 + 1
    x[0] += 1e4
    s, b, g = _t(rng, d), _t(rng, d), _t(rng, 64, d)
    got = fused_layer_norm_bwd(x, s, g)
    args = [t.double().requires_grad_() for t in (x, s, b)]
    want = torch.autograd.grad(layer_norm_reference(*args), args, g.double())
    for a, w in zip(got, want):
        torch.testing.assert_close(a.double(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,H,Hkv,Dh", [
    (1, 1, 1, 1, 6),          # one position, a tiny head dim
    (2, 37, 4, 2, 64),        # shorter than a tile, grouped-query
    (1, 130, 3, 1, 100),      # ragged tiles, MQA, Dh class 128
    (1, 70, 2, 2, 256),       # the widest head dim
    (1, 1, 4, 1, 64),         # T = 1 in the Dh-64 class, G = 4
    (2, 100, 8, 2, 64),       # T not a multiple of the 64-row tiles, G = 4
    (1, 65, 8, 2, 128),       # one row past the Dh-128 class's tiles, G = 4
    (1, 200, 4, 1, 128),      # several 32- and 64-row tiles, G = 4
    (1, 33, 4, 1, 256),       # one row past the Dh-256 class's 32-row tile, G = 4
])
@pytest.mark.parametrize("mode", ["causal", "window", "full"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_attention_kernels_match_plain(cuda, B, T, H, Hkv, Dh, mode, dtype, tol):
    """K2-fwd, K2-dq and K2-dkv against their plain versions on the same
    lse and delta, in every tile class and at its edges; atol/rtol 2e-5 in
    float32 as the reference pins its kernels, 2e-2 in bf16 (the kernels
    round p and ds to bf16 as the reference's do)."""
    rng = np.random.default_rng(6)
    q, do = _t(rng, B, T, H, Dh, dtype=dtype), _t(rng, B, T, H, Dh, dtype=dtype)
    k, v = _t(rng, B, T, Hkv, Dh, dtype=dtype), _t(rng, B, T, Hkv, Dh, dtype=dtype)
    causal, window = mode != "full", (max(1, T // 3) if mode == "window" else None)
    o, lse = flash_attention_fwd(q, k, v, causal, window)
    wo, wl = attention_fwd_reference(q, k, v, causal, window)
    torch.testing.assert_close(o, wo, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, wl, atol=tol, rtol=tol)
    delta = (do.float() * wo.float()).sum(-1).transpose(1, 2).contiguous() - 0.25
    got = (flash_attention_dq(q, k, v, do, wl, delta, causal, window),
           *flash_attention_dkv(q, k, v, do, wl, delta, causal, window))
    want = attention_bwd_reference(q, k, v, do, wl, delta, causal, window)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("rope", [False, True])
def test_backward_kernels_give_the_same_bits_twice(cuda, Dh, rope):
    """K2-dq and K2-dkv sum in a fixed order without atomics: two runs on
    the same inputs give bitwise-equal dq, dk and dv."""
    rng = np.random.default_rng(9)
    B, T, H, Hkv = 2, 300, 8, 2
    q, do = _t(rng, B, T, H, Dh), _t(rng, B, T, H, Dh)
    k, v = _t(rng, B, T, Hkv, Dh), _t(rng, B, T, Hkv, Dh)
    lse = attention_fwd_reference(q, k, v, True)[1]
    delta = _t(rng, B, H, T)
    if rope:
        c2, s2 = _tables(B, T, Dh)
        args = (q, k, v, do, lse, delta, c2, s2, True, None)
        runs = [(flash_attention_rope_dq(*args), *flash_attention_rope_dkv(*args))
                for _ in range(2)]
    else:
        args = (q, k, v, do, lse, delta, True, None)
        runs = [(flash_attention_dq(*args), *flash_attention_dkv(*args)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_gives_the_same_bits_twice(cuda, Dh, rope, dtype):
    """K2-fwd keeps each row's softmax statistics in one warp and sums in a
    fixed order: two runs on the same inputs give bitwise-equal o and
    lse."""
    rng = np.random.default_rng(12)
    B, T, H, Hkv = 2, 300, 8, 2
    q = _t(rng, B, T, H, Dh, dtype=dtype)
    k, v = _t(rng, B, T, Hkv, Dh, dtype=dtype), _t(rng, B, T, Hkv, Dh, dtype=dtype)
    if rope:
        c2, s2 = _tables(B, T, Dh)
        runs = [flash_attention_rope_fwd(q, k, v, c2, s2, True) for _ in range(2)]
    else:
        runs = [flash_attention_fwd(q, k, v, True) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_bf16_autograd_matches_plain(cuda):
    rng = np.random.default_rng(7)
    q = _t(rng, 2, 50, 4, 32, dtype=torch.bfloat16)
    k, v = (_t(rng, 2, 50, 2, 32, dtype=torch.bfloat16) for _ in range(2))
    g = _t(rng, 2, 50, 4, 32)
    grads = {}
    for route in ("kernel", "plain"):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = (flash_attention(*args, causal=True) if route == "kernel"
               else attention_fwd_reference(*args, True)[0])
        assert out.dtype == torch.bfloat16
        grads[route] = (out, *torch.autograd.grad((out.float() * g).sum(), args))
    for a, w in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a.float(), w.float(), atol=2e-2, rtol=2e-2)


def test_flash_attention_wrappers_refuse_bad_input(cuda):
    rng = np.random.default_rng(8)
    q = _t(rng, 1, 8, 2, 16)
    with pytest.raises(ValueError, match="head dim"):
        wide = _t(rng, 1, 8, 1, 264)
        flash_attention_fwd(wide, wide, wide, True)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_fwd(q, q, q, False, window=4)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_fwd(q, q.cpu(), q, True)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_fwd(q, q.double(), q.double(), True)
    with pytest.raises(ValueError, match="divide"):
        kv3 = _t(rng, 1, 8, 3, 16)
        flash_attention_fwd(_t(rng, 1, 8, 4, 16), kv3, kv3, True)
    stats = torch.zeros(1, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="lse"):
        flash_attention_dq(q, q, q, q, stats[:, :1], stats, True)
    with pytest.raises(ValueError, match="scale/bias"):
        fused_layer_norm_bwd(_t(rng, 2, 8), _t(rng, 7), _t(rng, 2, 8))


def _tables(B, T, Dh, first=0, theta=500000.0):
    pos = (first + 37 * torch.arange(B, device="cuda")[:, None]
           + torch.arange(T, device="cuda")[None, :])
    return make_rope_tables(*_rope_angles(pos, Dh, theta))


@pytest.mark.parametrize("B,T,H,Hkv,Dh,window,first", [
    (4, 2048, 32, 8, 128, None, 0),     # the Llama-3-8B training shape
    (2, 1000, 32, 8, 128, None, 0),     # ragged T
    (2, 1024, 8, 2, 64, None, 0),       # GQA at Dh 64
    (2, 1024, 32, 8, 128, 128, 0),      # a window
    (2, 512, 8, 2, 128, None, 4096),    # per-row position offsets
    (1, 1, 1, 1, 6, None, 3),           # one position, a tiny head dim
    (2, 37, 4, 2, 64, 5, 0),            # shorter than a tile, window
    (1, 130, 3, 1, 100, None, 7),       # ragged tiles, MQA, Dh class 128
    (1, 70, 2, 2, 256, None, 0),        # the widest head dim
    (1, 1, 4, 1, 128, None, 0),         # T = 1 in the Dh-128 class, G = 4
    (1, 65, 8, 2, 128, 17, 0),          # one row past a tile, G = 4, window
    (1, 33, 4, 1, 256, None, 5),        # one row past the Dh-256 tile, G = 4
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_rope_kernels_match_plain(cuda, B, T, H, Hkv, Dh, window, first, dtype, tol):
    """The rope-on-load K2-fwd, K2-dq and K2-dkv against their plain
    versions on the same lse and delta; atol/rtol 2e-5 in float32, 2e-2 in
    bf16."""
    rng = np.random.default_rng(10)
    q, do = _t(rng, B, T, H, Dh, dtype=dtype), _t(rng, B, T, H, Dh, dtype=dtype)
    k, v = _t(rng, B, T, Hkv, Dh, dtype=dtype), _t(rng, B, T, Hkv, Dh, dtype=dtype)
    c2, s2 = _tables(B, T, Dh, first)
    o, lse = flash_attention_rope_fwd(q, k, v, c2, s2, True, window)
    wo, wl = rope_attention_fwd_reference(q, k, v, c2, s2, True, window)
    torch.testing.assert_close(o, wo, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, wl, atol=tol, rtol=tol)
    delta = (do.float() * wo.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, wl, delta, c2, s2, True, window)
    got = (flash_attention_rope_dq(*args), *flash_attention_rope_dkv(*args))
    for a, w in zip(got, rope_attention_bwd_reference(*args)):
        torch.testing.assert_close(a, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_rope_autograd_matches_plain(cuda, dtype, tol):
    """``flash_attention_rope`` through autograd (kernels, delta, derotated
    gradients) against autograd through the plain forward, which
    differentiates the rotation itself; bf16 at bf16's 2e-2."""
    rng = np.random.default_rng(11)
    B, T, H, Hkv, Dh = 2, 300, 8, 2, 128
    q = _t(rng, B, T, H, Dh, dtype=dtype)
    k, v = (_t(rng, B, T, Hkv, Dh, dtype=dtype) for _ in range(2))
    g = _t(rng, B, T, H, Dh)
    c2, s2 = _tables(B, T, Dh, 11)
    grads = {}
    for route in ("kernel", "plain"):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        out = (flash_attention_rope(*args, c2, s2) if route == "kernel"
               else rope_attention_fwd_reference(*args, c2, s2, True)[0])
        assert out.dtype == dtype
        grads[route] = (out, *torch.autograd.grad((out.float() * g).sum(), args))
    for a, w in zip(grads["kernel"], grads["plain"]):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=tol)


def test_rope_wrappers_refuse_bad_tables(cuda):
    rng = np.random.default_rng(12)
    q = _t(rng, 2, 8, 2, 16)
    c2, s2 = _tables(2, 8, 16)
    stats = torch.zeros(2, 2, 8, device="cuda")
    strided = c2.transpose(0, 1).contiguous().transpose(0, 1)   # [2, 8, 16]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_rope_fwd(q, q, q, strided, s2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_rope_dq(q, q, q, q, stats, stats, c2, strided)
    with pytest.raises(ValueError, match=r"\[2, 8, 16\]"):
        flash_attention_rope_fwd(q, q, q, c2[:1], s2[:1])
    with pytest.raises(ValueError, match=r"\[2, 8, 16\]"):
        flash_attention_rope_dkv(q, q, q, q, stats, stats, c2[:, :4], s2[:, :4])
    with pytest.raises(ValueError, match="float32"):
        flash_attention_rope_fwd(q, q, q, c2.double(), s2)
    with pytest.raises(ValueError, match="even head dim"):
        odd = _t(rng, 2, 8, 2, 15)
        flash_attention_rope_fwd(odd, odd, odd, *_tables(2, 8, 14))
    with pytest.raises(ValueError, match="float32"):
        flash_attention_rope_fwd(q, q, q, c2.cpu(), s2)


def test_flash_decode_positional_matches_plain(cuda):
    """``flash_decode(q, k, v, pos, interpret, window)`` by position, as the
    reference's entry is called: the window lands in its place."""
    rng = np.random.default_rng(13)
    q, k, v = _t(rng, 2, 2, 4, 64), _t(rng, 2, 2, 300, 64), _t(rng, 2, 2, 300, 64)
    got = flash_decode(q, k, v, 250, False, 64)
    torch.testing.assert_close(got, decode_attention_reference(q, k, v, 250, 64),
                               atol=2e-5, rtol=2e-5)


def test_rotary_train_step_on_card_matches_cpu(cuda):
    """A rotary GQA model's flash train step: the card (the rope-on-load
    kernels, L launches of each, none of the plain K2) against the CPU
    (their plain versions) from the same weights; loss rtol 1e-4, every
    gradient within 1e-3 of its scale."""
    cfg = dict(vocab=97, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=192, max_len=128, activation="swiglu", norm="rmsnorm",
               attn_bias=False, ffn_bias=False, pos_encoding="rotary",
               rope_theta=500000.0)
    batch = make_lm_batches(np.random.default_rng(14).integers(0, 97, size=(2, 101)))
    out = {}
    for dev in ("cpu", "cuda"):
        model = TransformerLM(**cfg, device=dev)
        step, _ = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
        before = [f.launches for f in (flash_attention_rope_fwd, flash_attention_rope_dq,
                                       flash_attention_rope_dkv, flash_attention_fwd)]
        loss, grads = step.grad(model.init(4), *batch)
        after = [f.launches for f in (flash_attention_rope_fwd, flash_attention_rope_dq,
                                      flash_attention_rope_dkv, flash_attention_fwd)]
        if dev == "cuda":
            assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 0]
        out[dev] = (float(loss), {k_: g.cpu() for k_, g in grads.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for k_, w in out["cpu"][1].items():
        err = float((out["cuda"][1][k_] - w).abs().max())
        assert err <= 1e-3 * max(float(w.abs().max()), 1e-6), k_


def test_train_step_and_generate_on_card_match_cpu(cuda):
    """One flash train step and a greedy rollout: the card (kernels) and
    the CPU (plain versions) from the same weights. Loss rtol 1e-4; the
    tokens agree up to the first position whose top-1/top-2 logit gap is
    1e-3 or less (a near tie, where either choice is right)."""
    cfg = dict(vocab=97, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_len=64, activation="gelu", attn_bias=True,
               tie_embeddings=True)
    rows = np.random.default_rng(9).integers(0, 97, size=(2, 41))
    batch = make_lm_batches(rows)
    prompt = batch[0][:, :9]
    out = {}
    for dev in ("cpu", "cuda"):
        model = TransformerLM(**cfg, device=dev)
        params = model.init(3)
        step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3),
                                             attn="flash")
        _, _, loss = step(params, opt_init(params), *batch)
        out[dev] = (float(loss), model.generate(params, prompt, 8).cpu())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    seq = out["cpu"][1]
    pos = torch.arange(seq.shape[1] - 1).expand(seq.shape[0], -1)
    top2 = torch.topk(model.apply(params, seq[:, :-1].cuda(), pos.cuda()).cpu(),
                      2, dim=-1).values[:, prompt.shape[1] - 1:]
    for row in range(seq.shape[0]):
        for n, gap in enumerate((top2[row, :, 0] - top2[row, :, 1]).tolist()):
            if gap <= 1e-3:
                break
            t = prompt.shape[1] + n
            assert int(out["cuda"][1][row, t]) == int(seq[row, t]), (row, n)


def _paged(rng, S, hkv, g, dh, page, M, last, C=None, dtype=torch.float32):
    """q, a pool with a trash page of finite garbage, and a table of
    scattered pages left unmapped past each slot's last position."""
    P = S * M + 1
    kp, vp = _t(rng, P, hkv, page, dh, dtype=dtype), _t(rng, P, hkv, page, dh, dtype=dtype)
    kp[0] = vp[0] = 1e4
    table = (1 + rng.permutation(S * M)).reshape(S, M).astype(np.int32)
    for s, p in enumerate(last):
        table[s, p // page + 1:] = 0
    q = _t(rng, S, hkv, g, dh) if C is None else _t(rng, S, hkv, g, C, dh)
    return q, kp, vp, torch.from_numpy(table).cuda()


@pytest.mark.parametrize("S,hkv,g,dh,page,M", [
    (3, 2, 5, 6, 4, 9),        # odd group, scalar loads, pages of 4
    (2, 1, 1, 128, 128, 3),    # a page longer than the key tile
    (4, 3, 2, 32, 1, 70),      # one position per page
])
@pytest.mark.parametrize("window", [None, 7])
def test_paged_kernels_match_plain(cuda, S, hkv, g, dh, page, M, window):
    """K5-decode and K5-chunk against their plain versions; atol/rtol 2e-5
    as the reference pins its attention kernels."""
    rng = np.random.default_rng(10)
    T = M * page
    pos = np.linspace(0, T - 1, S).astype(np.int32)
    q, kp, vp, table = _paged(rng, S, hkv, g, dh, page, M, pos)
    pos_t = torch.from_numpy(pos).cuda()
    for a, w in zip(paged_flash_decode_lse(q, kp, vp, table, pos_t, page, window),
                    paged_decode_reference_lse(q, kp, vp, table, pos_t, page, window)):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)
    C = min(5, T)
    pos0 = np.minimum(pos, T - C)
    q, kp, vp, table = _paged(rng, S, hkv, g, dh, page, M, pos0 + C - 1, C)
    p0 = torch.from_numpy(pos0).cuda()
    torch.testing.assert_close(paged_flash_chunk(q, kp, vp, table, p0, page, window),
                               paged_chunk_reference(q, kp, vp, table, p0, page, window),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("page,M", [(4, 24), (16, 8)])
@pytest.mark.parametrize("g,dh", [(1, 64), (4, 6)])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_paged_decode_every_position_matches_plain(cuda, page, M, g, dh, window, dtype, tol):
    """K5-decode at every position 0 .. T-1 of a small table (8 slots a
    launch), so every split of the pos-driven rule is empty, short, partial
    or full somewhere: against the plain version at atol = rtol = 2e-5
    (2e-2 with a bf16 pool), and the same bits from a second launch."""
    rng = np.random.default_rng(page * 100 + g)
    T, S = M * page, 8
    for first in range(0, T, S):
        pos = np.minimum(np.arange(first, first + S), T - 1).astype(np.int32)
        q, kp, vp, table = _paged(rng, S, 2, g, dh, page, M, pos, dtype=dtype)
        pos_t = torch.from_numpy(pos).cuda()
        got = paged_flash_decode_lse(q, kp, vp, table, pos_t, page, window)
        want = paged_decode_reference_lse(q, kp, vp, table, pos_t, page, window)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=tol, rtol=tol)
        for a, w in zip(paged_flash_decode_lse(q, kp, vp, table, pos_t, page, window), got):
            assert torch.equal(a, w)


@pytest.mark.parametrize("S,hkv,g,dh,page,M,pos", [
    (8, 12, 1, 64, 16, 64, [31, 15, 16, 511, 512, 700, 1000, 1023]),   # GPT-2 paged
    (8, 8, 4, 128, 16, 128, [0, 31, 256, 700, 1023, 1500, 2000, 2047]),  # Mixtral widths
    (4, 2, 12, 256, 8, 40, [0, 100, 250, 319]),   # two groups of query rows a head
    (6, 3, 2, 32, 1, 300, [0, 1, 2, 150, 298, 299]),   # one position a page
])
def test_paged_decode_shapes_match_plain(cuda, S, hkv, g, dh, page, M, pos):
    """K5-decode at the decode shapes the port runs, a group wider than a
    block's 8 query rows and one-row pages: atol = rtol = 2e-5 against the
    plain version, the same bits twice."""
    rng = np.random.default_rng(S * hkv + g)
    q, kp, vp, table = _paged(rng, S, hkv, g, dh, page, M, pos)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    got = paged_flash_decode_lse(q, kp, vp, table, pos_t, page)
    want = paged_decode_reference_lse(q, kp, vp, table, pos_t, page)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)
    for a, w in zip(paged_flash_decode_lse(q, kp, vp, table, pos_t, page), got):
        assert torch.equal(a, w)


@pytest.mark.parametrize("S,hkv,g,dh,page,M,C,pos0,window,dtype", [
    (1, 12, 1, 64, 16, 64, 256, [0], None, torch.float32),       # GPT-2 insert
    (1, 12, 1, 64, 16, 64, 256, [128], None, torch.float32),     # an adopted prefix
    (8, 12, 1, 64, 16, 64, 4, [0, 15, 16, 29, 511, 700, 1000, 1020], None, torch.float32),
    (4, 2, 4, 128, 16, 64, 4, [31, 512, 700, 1020], None, torch.float32),
    (2, 12, 1, 64, 16, 64, 256, [0, 300], 100, torch.float32),
    (2, 12, 1, 64, 8, 128, 256, [0, 128], None, torch.float32),
    (2, 12, 1, 64, 64, 16, 256, [0, 128], None, torch.float32),
    (1, 12, 1, 64, 16, 64, 256, [128], None, torch.bfloat16),
    (1, 8, 4, 128, 16, 128, 256, [0], None, torch.float32),      # Mixtral insert
    (2, 8, 4, 128, 16, 128, 256, [0, 700], 300, torch.bfloat16),
    (2, 2, 3, 256, 8, 40, 37, [0, 250], None, torch.float32),    # Dh 256, odd group
    (2, 3, 2, 42, 4, 30, 19, [2, 100], 9, torch.float32),        # Dh 42: element copies
    (2, 3, 2, 36, 4, 30, 19, [2, 100], None, torch.bfloat16),    # 72-byte bf16 rows
])
def test_paged_chunk_shapes_match_plain(cuda, S, hkv, g, dh, page, M, C, pos0, window, dtype):
    """K5-chunk on the tensor cores at ``chip_smoke.py``'s chunk cases, the
    Mixtral insert shape (Hkv 8, G 4, Dh 128, C 256) and the tile classes'
    edges: atol = rtol = 2e-5 against the plain version, which widens a bf16
    pool to float32 (a bf16 value is exact in TF32: the kernel keeps the
    float32 pin), and the same bits from a second launch."""
    rng = np.random.default_rng(S * hkv * g + C)
    q, kp, vp, table = _paged(rng, S, hkv, g, dh, page, M, np.asarray(pos0) + C - 1, C,
                              dtype=dtype)
    p0 = torch.tensor(pos0, dtype=torch.int32, device="cuda")
    got = paged_flash_chunk(q, kp, vp, table, p0, page, window)
    torch.testing.assert_close(got, paged_chunk_reference(q, kp, vp, table, p0, page, window),
                               atol=2e-5, rtol=2e-5)
    assert torch.equal(paged_flash_chunk(q, kp, vp, table, p0, page, window), got)


def test_paged_decode_window_past_the_table_matches_plain(cuda):
    """K5-decode with a window at positions past the table's M*page: the
    visible rows start at pos - window + 1 from the unclipped pos, as the
    plain version's mask has them."""
    rng = np.random.default_rng(15)
    page, M = 8, 8
    pos = np.arange(M * page, M * page + 8, dtype=np.int32)
    q, kp, vp, table = _paged(rng, 8, 2, 2, 64, page, M, np.minimum(pos, M * page - 1))
    pos_t = torch.from_numpy(pos).cuda()
    for a, w in zip(paged_flash_decode_lse(q, kp, vp, table, pos_t, page, 12),
                    paged_decode_reference_lse(q, kp, vp, table, pos_t, page, 12)):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)


def test_paged_wrappers_refuse_bad_input(cuda):
    rng = np.random.default_rng(11)
    q, kp, vp, table = _paged(rng, 2, 1, 1, 8, 4, 3, [5, 5])
    with pytest.raises(ValueError, match="page"):
        paged_flash_decode_lse(q, kp, vp, table, 5, 8)
    with pytest.raises(ValueError, match="int32"):
        paged_flash_decode_lse(q, kp, vp, table.long(), 5, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_flash_chunk(q[:, :, :, None], kp.cpu(), vp, table, 5, 4)
    with pytest.raises(ValueError, match="head dim"):
        wide = _t(rng, 2, 1, 4, 264)
        paged_flash_decode_lse(_t(rng, 2, 1, 1, 264), wide, wide, table, 5, 4)


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=8, fuse_k=3),
                                dict(pages_per_partition=12, prefix_cache=False)])
def test_paged_engine_on_card_matches_dense_and_cpu(cuda, kw):
    """The paged engine on the card (K5) against the dense engine on the
    card and the paged engine on the CPU, on a mix with a shared prefix;
    with a small pool it preempts. Greedy tokens, no near tie at this
    size."""
    cfg = dict(vocab=97, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=128, max_len=64, activation="gelu", attn_bias=True,
               tie_embeddings=True)
    rng = np.random.default_rng(12)
    system = rng.integers(0, 97, size=16).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 97, size=n).astype(np.int32)])
               for n in (3, 9, 5, 7)]
    out = {}
    for dev, paged in (("cuda", False), ("cuda", True), ("cpu", True)):
        model = TransformerLM(**cfg, device=dev)
        eng = ServingEngine(model, model.init(5), n_slots=4, device=dev,
                            **(dict(paged=True, page_size=8, **kw) if paged else {}))
        ids = [eng.submit(p, 16) for p in prompts]
        fin = eng.drain()
        out[(dev, paged)] = [fin[i].tokens for i in ids]
        if paged:
            eng.kv.check()
    assert out[("cuda", True)] == out[("cuda", False)] == out[("cpu", True)]


@pytest.mark.parametrize("C", [2, 3, 4, 5])
def test_paged_chunk_at_the_verify_shape_matches_plain(cuda, C):
    """K5-chunk at the paged speculative verify's shape: GPT-2's 8 slots
    (Hkv 12, G 1, Dh 64, pages of 16), C = speculate_k rows at unaligned
    per-slot positions of the serve mix, several crossing a page edge:
    atol = rtol = 2e-5 against the plain version, the same bits twice."""
    rng = np.random.default_rng(40 + C)
    pos0 = np.array([33, 62, 100, 143, 207, 254, 287, 318], np.int32)
    assert any(p // 16 != (p + C - 1) // 16 for p in pos0)
    q, kp, vp, table = _paged(rng, 8, 12, 1, 64, 16, 64, pos0 + C - 1, C)
    p0 = torch.from_numpy(pos0).cuda()
    got = paged_flash_chunk(q, kp, vp, table, p0, 16)
    torch.testing.assert_close(got, paged_chunk_reference(q, kp, vp, table, p0, 16),
                               atol=2e-5, rtol=2e-5)
    assert torch.equal(paged_flash_chunk(q, kp, vp, table, p0, 16), got)


def _near_tie_agree(model, params, prompts, got, want):
    """``got`` equals ``want`` up to each request's first position whose
    top-2 logit gap is 1e-3 or less (there either token is right); returns
    how many positions were compared."""
    compared = 0
    for prompt, a, b in zip(prompts, got, want):
        seq = np.concatenate([prompt, np.asarray(b[:-1], np.int32)]).astype(np.int64)
        with torch.no_grad():
            logits, _ = model.decode_chunk(params, torch.from_numpy(seq)[None].cuda(), 0,
                                           model.init_cache(1, len(seq)))
        top = torch.topk(logits[0, len(prompt) - 1:], 2, dim=-1).values.cpu()
        for n, gap in enumerate((top[:, 0] - top[:, 1]).tolist()):
            if gap <= 1e-3:
                break
            assert a[n] == b[n], n
            compared += 1
    return compared


@pytest.mark.parametrize("drafter", ["ngram", "model"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_engine_on_card(cuda, paged, drafter):
    """``speculate_k=4`` on the card: exact launch counts (K3-fwd 2L+1 per
    verify round, sequential step and insert, 2L_d+1 per draft step and
    draft insert; K4 L per sequential step on the dense engine and L_d per
    draft step; K5-chunk L per insert and verify round and K5-decode L per
    sequential step on the paged engine, which launches no K4 of its own),
    and the tokens of the ``speculate_k=1`` engine up to near ties."""
    from elephas_tpu_torch.serving import ModelDrafter

    cfg = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=96,
               activation="gelu", attn_bias=True, tie_embeddings=True)
    model = TransformerLM(**cfg, device="cuda")
    params = model.init(5)
    rng = np.random.default_rng(13)
    prompts = [np.tile(rng.integers(0, 97, size=n).astype(np.int32), 3) for n in (3, 9, 5, 7)]
    kw = dict(n_slots=4, device="cuda", **(dict(paged=True, page_size=8) if paged else {}))
    base = ServingEngine(model, params, **kw)
    ids = [base.submit(p, 24) for p in prompts]
    fin = base.drain()
    want = [fin[i].tokens for i in ids]
    dr = ModelDrafter(model, params) if drafter == "model" else None
    eng = ServingEngine(model, params, speculate_k=4, drafter=dr, **kw)
    counters = (fused_layer_norm, flash_decode_lse, paged_flash_decode_lse, paged_flash_chunk)
    for c in counters:
        c.launches = 0
    ids = [eng.submit(p, 24) for p in prompts]
    fin = eng.drain()
    k3, k4, k5d, k5c = (c.launches for c in counters)
    snap = eng.snapshot()
    rounds = snap["fastpath"]["spec_rounds"]
    steps = snap["engine"]["decode_steps"] - rounds
    inserts = snap["engine"]["prefills"]
    L = cfg["n_layers"]
    d_steps, d_prefills = (dr.steps, dr.prefills) if dr else (0, 0)
    assert rounds > 0 and (d_prefills == inserts if dr else True)
    assert k3 == (2 * L + 1) * (rounds + steps + inserts) + (2 * L + 1) * (d_steps + d_prefills)
    if paged:
        eng.kv.check()
        assert (k4, k5d, k5c) == (L * d_steps, L * steps, L * (inserts + rounds))
    else:
        assert (k4, k5d, k5c) == (L * steps + L * d_steps, 0, 0)
    got = [fin[i].tokens for i in ids]
    assert _near_tie_agree(model, params, prompts, got, want) > 0


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("tiles,K,N,tm,dtype", [
    ([0, 0, 2, 3, 3], 200, 100, 128, torch.float32),   # empty expert 1, ragged
    ([1, 1, 1], 1, 1, 128, torch.float32),             # K = N = 1
    ([0, 1, 1, 3], 300, 260, 256, torch.float32),      # two block rows per tile
    ([0, 2, 2, 2], 136, 72, 128, torch.bfloat16),
    ([0, 1, 2, 3], 14336, 256, 128, torch.float32),    # w2's contraction
    ([0, 1, 3, 3], 1001, 131, 256, torch.float32),     # K, N no multiple of 4
    ([0, 2, 2, 3], 201, 99, 128, torch.bfloat16),      # rows not 16-byte aligned
    ([1, 2, 3, 3], 14336, 136, 128, torch.bfloat16),
    ([0] * 72, 256, 384, 128, torch.float32),          # tgmm over 9216 rows
    ([0] * 72, 256, 384, 128, torch.bfloat16),
])
def test_grouped_matmul_kernels_match_plain(cuda, tiles, K, N, tm, dtype):
    """K6-gmm (and its transposed twin) and K6-tgmm against the plain
    versions: max |diff| / max |plain| <= 2e-5 in float32 (8e-3 for a bf16
    output, one rounding of a float32 sum; tgmm's float32 output holds 2e-5
    from bf16 inputs too), at contraction 14336 and at 9216 rows on one
    expert (the tensor cores' 3xTF32 products, each stage of the
    contraction summed fresh);
    experts without a tile get an exact zero weight gradient; the same bits
    on a second launch of each kernel."""
    rng = np.random.default_rng(13)
    E = 4
    gmap = torch.tensor(tiles, dtype=torch.int32, device="cuda")
    M = len(tiles) * tm
    lhs, g = _t(rng, M, K, dtype=dtype), _t(rng, M, N, dtype=dtype)
    w, w_t = _t(rng, E, K, N, dtype=dtype), _t(rng, E, N, K, dtype=dtype)
    tol = 2e-5 if dtype == torch.float32 else 8e-3
    out, out_t = gmm(lhs, w, gmap), gmm_t(lhs, w_t, gmap)
    assert _rel(out, gmm_reference(lhs, w, gmap)) <= tol
    assert _rel(out_t, gmm_reference(lhs, w_t, gmap, True)) <= tol
    assert torch.equal(out, gmm(lhs, w, gmap))
    assert torch.equal(out_t, gmm_t(lhs, w_t, gmap))
    got = tgmm(lhs, g, gmap, E)
    assert got.dtype == torch.float32
    assert _rel(got, tgmm_reference(lhs, g, gmap, E)) <= 2e-5
    for e in set(range(E)) - set(tiles):
        assert bool((got[e] == 0).all())
    assert torch.equal(got, tgmm(lhs, g, gmap, E))
    assert tgmm(lhs, g, gmap, E, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_all_sentinel_tile_and_clamped_expert(cuda, dtype):
    """An expert whose only tile holds sentinel rows (zeros, as the MoE
    layout pads it) gets exactly zero output rows from gmm and gmm_t, and
    its weight gradient from tgmm is zero; a gmap entry past the last
    expert reads the last one (clamped), as the plain version's
    ``rhs[e]`` would fail to."""
    rng = np.random.default_rng(15)
    E, K, N = 4, 4096, 384
    gmap = torch.tensor([0, 1, 2, 2], dtype=torch.int32, device="cuda")
    lhs = _t(rng, 512, K, dtype=dtype)
    lhs[128:256] = 0                                      # expert 1: sentinels only
    w, w_t = _t(rng, E, K, N, dtype=dtype), _t(rng, E, N, K, dtype=dtype)
    out, out_t = gmm(lhs, w, gmap), gmm_t(lhs, w_t, gmap)
    assert bool((out[128:256] == 0).all()) and bool((out_t[128:256] == 0).all())
    assert bool((tgmm(lhs, _t(rng, 512, N, dtype=dtype), gmap, E)[1] == 0).all())
    tol = 2e-5 if dtype == torch.float32 else 8e-3
    assert _rel(out, gmm_reference(lhs, w, gmap)) <= tol
    past = torch.tensor([0, 1, 2, 9], dtype=torch.int32, device="cuda")
    clamped = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device="cuda")
    assert torch.equal(gmm(lhs, w, past), gmm(lhs, w, clamped))


def test_grouped_matmul_wrappers_refuse_bad_input(cuda):
    rng = np.random.default_rng(14)
    gmap = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    w = _t(rng, 2, 8, 8)
    with pytest.raises(ValueError, match="multiple"):
        gmm(_t(rng, 128, 8), w, gmap)                        # tm 64
    with pytest.raises(ValueError, match="bfloat16"):
        gmm(_t(rng, 256, 8, dtype=torch.bfloat16), w, gmap)  # mixed dtypes
    with pytest.raises(ValueError, match="contraction"):
        gmm(_t(rng, 256, 9), w, gmap)
    with pytest.raises(ValueError, match="one CUDA device"):
        gmm(_t(rng, 256, 8), w, gmap.cpu())


def test_moe_engine_train_and_generate_on_card_match_cpu(cuda):
    """A small Mixtral-shaped MoE LM (``moe_dispatch="gmm"``): the dense and
    paged engines on the card against the CPU engine (greedy tokens, no
    near tie at this size), ``generate`` against the card engine, and one
    train step's loss (rtol 1e-4) and gradients (1e-3 of each one's scale)
    on the card against the CPU."""
    cfg = dict(vocab=97, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=96, max_len=64, n_experts=8, k=2, capacity_factor=4.0,
               aux_weight=0.02, activation="swiglu", ffn_bias=False,
               norm="rmsnorm", pos_encoding="rotary", moe_dispatch="gmm")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in (3, 9, 5, 17)]
    rows = rng.integers(0, 97, size=(2, 41))
    out = {}
    for dev in ("cpu", "cuda"):
        model = MoETransformerLM(**cfg, device=dev)
        params = model.init(3)
        toks = []
        for paged in (False, True):
            eng = ServingEngine(model, params, n_slots=4, device=dev,
                                **(dict(paged=True, page_size=8) if paged else {}))
            ids = [eng.submit(p, 12) for p in prompts]
            fin = eng.drain()
            toks.append([fin[i].tokens for i in ids])
        gen = model.generate(params, np.stack([p[:3] for p in prompts]), 6).cpu()
        step, _ = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
        loss, grads = step.grad(params, *make_lm_batches(rows))
        out[dev] = (toks, gen, float(loss), {k: v.cpu() for k, v in grads.items()})
    assert out["cuda"][0][0] == out["cuda"][0][1] == out["cpu"][0][0]
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)
    for k, g in out["cpu"][3].items():
        scale = max(float(g.abs().max()), 1e-6)
        assert float((out["cuda"][3][k] - g).abs().max()) <= 1e-3 * scale, k


def _xent_case(rng, B, C, dtype=torch.float32):
    x = torch.from_numpy((rng.normal(size=(B, C)) * 3).astype(np.float32)).to("cuda", dtype)
    y = np.zeros((B, C), np.float32)
    y[np.arange(B), rng.integers(0, C, size=B)] = 1.0
    y[0] = 0.0                                   # a zero-label row
    if B > 1:
        y[1, : min(C, 3)] += 0.5                 # a row summing past 1
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32)).cuda()
    return x, torch.from_numpy(y).cuda(), g


@pytest.mark.parametrize("B,C", [(1, 1), (3, 10), (9, 31), (17, 1024), (5, 1025),
                                 (2, 4099), (1024, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_kernels_match_plain(cuda, B, C, dtype):
    """K1 at ragged widths on every route (one warp a row up to C 1024, the
    cluster past it), bf16 logits, zero and soft label rows. Loss within
    1e-5 relative to the row's scale (float32 sums in another order); dx
    within 1e-6 in float32 and one bf16 ulp (2**-8 relative) in bf16."""
    rng = np.random.default_rng(B * 7 + C)
    x, y, g = _xent_case(rng, B, C, dtype)
    got = fused_xent_fwd(x, y)
    want = fused_xent_fwd_reference(x, y)
    assert got.dtype == torch.float32 and got.shape == (B,)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert got[0].item() == 0.0
    dx = fused_xent_bwd(x, y, g)
    assert dx.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(dx.float(), fused_xent_bwd_reference(x, y, g).float(),
                               atol=tol, rtol=tol)


def test_fused_xent_positional_interpret_runs_on_card(cuda):
    """``fused_xent_from_logits(x, y, True)``, the reference's positional
    call: ``interpret`` is accepted and ignored; K1-fwd and K1-bwd run and
    equal their plain versions (atol = rtol = 1e-5)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy((rng.normal(size=(64, 130)) * 3).astype(np.float32)).cuda()
    y = torch.eye(130, device="cuda")[torch.from_numpy(rng.integers(0, 130, size=64)).cuda()]
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).cuda()
    before = (fused_xent_fwd.launches, fused_xent_bwd.launches)
    xt = x.clone().requires_grad_()
    out = fused_xent_from_logits(xt, y, True)
    (dx,) = torch.autograd.grad(out, xt, g)
    assert (fused_xent_fwd.launches, fused_xent_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, fused_xent_fwd_reference(x, y), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx, fused_xent_bwd_reference(x, y, g), atol=1e-5, rtol=1e-5)


def test_fused_xent_autograd_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    x, y, g = _xent_case(rng, 64, 130)
    out = {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).clone().requires_grad_()
        loss = categorical_crossentropy_from_logits(xd, y.to(dev))
        (dx,) = torch.autograd.grad(loss, xd, g.to(dev))
        out[dev] = (loss.detach().cpu(), dx.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-6, rtol=1e-6)


def test_fused_xent_wrappers_refuse_bad_input(cuda):
    rng = np.random.default_rng(6)
    x, y, g = _xent_case(rng, 4, 10)
    with pytest.raises(ValueError, match="CUDA"):
        fused_xent_fwd(x.cpu(), y.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        fused_xent_bwd(x.cpu(), y.cpu(), g.cpu())
    with pytest.raises(ValueError, match="one device"):
        fused_xent_fwd(x, y.cpu())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_xent_fwd(x.half(), y)
    with pytest.raises(ValueError, match=r"\[B, C\]"):
        fused_xent_fwd(x[None], y[None])
    with pytest.raises(ValueError, match="cotangent"):
        fused_xent_bwd(x, y, g[:3])
    empty = fused_xent_fwd(x[:0], y[:0])
    assert empty.shape == (0,)


# the widest rows the cluster route holds (tests/test_torch_fused_xent.py)
XENT_CLUSTER_CAP = {torch.float32: 8 * 28920, torch.bfloat16: 8 * 38560}


@pytest.mark.parametrize("C", [1, 10, 16, 17, 32, 33, 128, 129, 999, 1000, 1024, 1025, 12800,
                               12801, 50257, "cap", "cap+1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_routes_at_their_boundaries(cuda, C, dtype):
    """K1 on each route at and across its boundaries (the warp route's
    division up to 128, warp / cluster at 1024, one CTA / two at 12800,
    cluster / stream at the cluster's capacity),
    ragged B (a part-filled last block), zero and soft label rows: the
    plain version's pins (loss 1e-5, dx 1e-6 float32 / 2**-8 bf16), the
    zero-label row exactly 0, and the same bits on a second run."""
    from elephas_tpu_torch.ops.fused_xent import ROUTES, xent_plan

    cap = XENT_CLUSTER_CAP[dtype]
    C = {"cap": cap, "cap+1": cap + 1}.get(C, C)
    want_route = "warp" if C <= 1024 else "cluster" if C <= cap else "stream"
    assert ROUTES[xent_plan(C, torch.tensor([], dtype=dtype).element_size())[0]] == want_route
    B = 37 if C <= 1024 else 3
    rng = np.random.default_rng(C)
    x, y, g = _xent_case(rng, B, C, dtype)
    got, dx = fused_xent_fwd(x, y), fused_xent_bwd(x, y, g)
    torch.testing.assert_close(got, fused_xent_fwd_reference(x, y), atol=1e-5, rtol=1e-5)
    assert got[0].item() == 0.0
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(dx.float(), fused_xent_bwd_reference(x, y, g).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got, fused_xent_fwd(x, y))
    assert torch.equal(dx, fused_xent_bwd(x, y, g))


@pytest.mark.parametrize("C", [10, 16, 1000, 4096, 50257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_misaligned_rows_match_plain(cuda, C, dtype):
    """Logits one element past an aligned address (and labels one past
    theirs): the warp route falls back to scalar loads, the cluster's bulk
    copies shift their unaligned ends."""
    rng = np.random.default_rng(C + 3)
    B = 5
    x0, y0, g = _xent_case(rng, B, C, dtype)
    xbuf = torch.empty(B * C + 1, dtype=dtype, device="cuda")
    ybuf = torch.empty(B * C + 1, device="cuda")
    x = xbuf[1:].view(B, C).copy_(x0)
    y = ybuf[1:].view(B, C).copy_(y0)
    torch.testing.assert_close(fused_xent_fwd(x, y), fused_xent_fwd_reference(x, y),
                               atol=1e-5, rtol=1e-5)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(fused_xent_bwd(x, y, g).float(),
                               fused_xent_bwd_reference(x, y, g).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,C", [(1024, 10), (64, 130), (3, 50257)])
def test_fused_xent_autograd_routes_match_cpu(cuda, B, C):
    """``fused_xent_from_logits`` under autograd on the card (the warp
    route at the fit's shape and past 128 classes, the cluster route)
    against the dispatcher's plain path on the CPU."""
    rng = np.random.default_rng(B + C)
    x, y, g = _xent_case(rng, B, C)
    xd = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(fused_xent_from_logits(xd, y), xd, g)
    xc = x.cpu().requires_grad_()
    loss = categorical_crossentropy_from_logits(xc, y.cpu())
    (dxc,) = torch.autograd.grad(loss, xc, g.cpu())
    torch.testing.assert_close(fused_xent_from_logits(x, y).cpu(), loss.detach(),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx.cpu(), dxc, atol=1e-6, rtol=1e-6)


def test_fused_xent_bad_plans_raise(cuda):
    """A cluster launch whose slice needs more shared memory than a CTA has
    raises (no zeros come back, no launch is counted), as do plans the C
    side does not take; the kernels run on after."""
    from elephas_tpu_torch.ops import fused_xent as X

    rng = np.random.default_rng(8)
    x, y, g = _xent_case(rng, 2, 120000)
    out = torch.full((2,), 7.0, device="cuda")
    before = (fused_xent_fwd.launches, fused_xent_bwd.launches)
    cluster = X.ROUTES.index("cluster")
    for entry, gg, o in (("fused_xent_fwd", None, out),
                         ("fused_xent_bwd", g, torch.empty_like(x))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            X._launch(entry, x, y, gg, o, plan=(cluster, 1, 2, 60000))   # 480 KB a CTA
        with pytest.raises(RuntimeError, match="CUDA error"):
            X._launch(entry, x, y, gg, o, plan=(cluster, 1, 9, 13336))   # 9 CTAs
        with pytest.raises(RuntimeError, match="CUDA error"):
            X._launch(entry, x, y, gg, o, plan=(cluster, 1, 8, 15002))   # slice not a unit
        with pytest.raises(RuntimeError, match="CUDA error"):
            X._launch(entry, x, y, gg, o, plan=(X.ROUTES.index("warp"), 1, 1, 0))  # C > 1024
        with pytest.raises(RuntimeError, match="CUDA error"):
            X._launch(entry, x, y, gg, o, plan=(len(X.ROUTES), 1, 1, 0))   # no such route
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((2,), 7.0, device="cuda"))
    assert (fused_xent_fwd.launches, fused_xent_bwd.launches) == before
    torch.testing.assert_close(fused_xent_fwd(x, y), fused_xent_fwd_reference(x, y),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C", [50257, "cap+1"], ids=["cluster", "stream"])
def test_fused_xent_masked_slice_matches_plain(cuda, C):
    """A CTA's whole slice of -inf logits (a masked block of a vocabulary)
    on the cluster and stream routes: dx finite and within 1e-6 of the
    plain version, which takes the row's max; the loss within 1e-5, NaN
    where the plain version's y * (lse - x) is 0 * inf too."""
    from elephas_tpu_torch.ops.fused_xent import xent_plan

    C = XENT_CLUSTER_CAP[torch.float32] + 1 if C == "cap+1" else C
    _, _, n, sl = xent_plan(C, 4)
    rng = np.random.default_rng(C + 5)
    x, y, g = _xent_case(rng, 4, C)
    x[2:, sl:min(C, 2 * sl)] = -torch.inf
    y[2:] = 0.0
    y[2:, 0] = 1.0
    dx = fused_xent_bwd(x, y, g)
    assert bool(torch.isfinite(dx).all())
    torch.testing.assert_close(dx, fused_xent_bwd_reference(x, y, g), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(fused_xent_fwd(x, y), fused_xent_fwd_reference(x, y),
                               atol=1e-5, rtol=1e-5, equal_nan=True)


@pytest.mark.parametrize("C", [10, 129, 1024, 1025, 50257, "cap", "cap+1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_launch_shape_matches_plan(cuda, C, dtype):
    """The launch the library reports for each plan: one warp a row, four
    rows a block; a cluster's CTAs with the shared memory the plan's
    ``_cluster_smem`` counts, within the budget; the stream's eight CTAs a
    row with none. A slice one unit past the cluster's capacity is
    refused, so the plan's budget is the library's."""
    from elephas_tpu_torch.ops import fused_xent as X

    itemsize = torch.tensor([], dtype=dtype).element_size()
    cap = XENT_CLUSTER_CAP[dtype]
    C = {"cap": cap, "cap+1": cap + 1}.get(C, C)
    plan = X.xent_plan(C, itemsize)
    route, _, n, sl = plan
    want = {"warp": (10, 128, 0), "cluster": (37 * n, 256, X._cluster_smem(sl, itemsize)),
            "stream": (37 * 8, 256, 0)}[X.ROUTES[route]]
    assert X.launch_shape(37, C, dtype, plan) == want
    assert want[2] <= X._SMEM_BUDGET
    over = cap // 8 + 8
    with pytest.raises(RuntimeError, match="CUDA error"):
        X.launch_shape(37, 8 * over, dtype, (X.ROUTES.index("cluster"), 1, 8, over))


def test_mlp_fit_on_card_matches_cpu(cuda):
    """The MNIST MLP's JSON (dropout off) fitted on the card and on the CPU
    from the same weights and order, in the five schedules: histories and
    weights within 1e-4 relative to their scale (float32; cuBLAS sums in
    another order than the CPU's BLAS, compounded over the fit's steps)."""
    import json
    from pathlib import Path

    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    path = Path(__file__).resolve().parents[1] / "elephas_tpu_torch" / "configs" / \
        "mnist_mlp_logits.json"
    cfg = json.loads(path.read_text())
    for layer in cfg["config"]["layers"]:
        if layer["class_name"] == "Dropout":
            layer["config"]["rate"] = 0.0
    rng = np.random.default_rng(7)
    x = rng.random((600, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=600)]
    for mode, freq in [("synchronous", "epoch"), ("synchronous", "batch"),
                       ("asynchronous", "epoch"), ("asynchronous", "batch"),
                       ("hogwild", "epoch")]:
        out = {}
        for dev in ("cuda", "cpu"):
            sm = SparkModel(json.dumps(cfg), mode=mode, frequency=freq,
                            parameter_server_mode="jax", num_workers=3, device=dev)
            sm.fit(to_simple_rdd(SparkContext("local[3]"), x, y), epochs=2, batch_size=32,
                   validation_split=0.1)
            out[dev] = (sm.training_histories[-1], sm.master_network.get_weights())
        for k, v in out["cpu"][0].items():
            np.testing.assert_allclose(out["cuda"][0][k], v, rtol=1e-4, atol=1e-4)
        for a, b in zip(out["cuda"][1], out["cpu"][1]):
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-3)


RACE_CU = r"""
#include <cuda_runtime.h>
__global__ void race_kernel(float* x) { x[threadIdx.x] += 1.0f; }
extern "C" int race_launch(void* x, void* stream) {
  race_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(x));
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def test_threads_racing_a_first_load_build_once(cuda, tmp_path, monkeypatch):
    """Eight threads that reach a kernel's first ``_build.load`` together
    start ``nvcc`` once, load one library, and count every launch."""
    import ctypes
    import threading

    from elephas_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "race_kernel.cu"
    src.write_text(RACE_CU)
    starts = []
    real_start = _build._start

    def counting_start(name, src=None):
        starts.append(name)
        return real_start(name, src)

    monkeypatch.setattr(_build, "_start", counting_start)
    name = f"race_kernel_{tmp_path.name}"
    x = torch.zeros(32, device=cuda)

    def wrapper():
        lib = _build.load(name, {"race_launch": [ctypes.c_void_p, ctypes.c_void_p]},
                          src=src)
        _build.check(lib, lib.race_launch(x.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream),
                     "race_launch")
        _build.count_launch(wrapper)
        return lib

    wrapper.launches = 0
    barrier = threading.Barrier(8)
    libs = []

    def run():
        barrier.wait(timeout=60)
        for _ in range(50):
            libs.append(wrapper())

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    assert starts == [name]
    assert len({id(lib) for lib in libs}) == 1 and len(libs) == 400
    assert wrapper.launches == 400
    assert float(x[0]) == 400.0
    _build._loaded.pop(name, None)


@pytest.mark.parametrize("frequency", ["epoch", "batch"])
def test_host_fit_launches_k1_exactly_from_worker_threads(cuda, frequency):
    """The MNIST MLP's JSON through the host path (asynchronous, http, two
    worker threads): K1-fwd launched exactly sum over workers of E (S_w +
    Sv_w) times (``"epoch"``: each epoch a ``model.fit`` with the last
    partial batch and the validation rows) or E * steps (``"batch"``:
    ``train_on_batch`` on whole batches), K1-bwd once per training batch,
    no other kernel; the loss falls."""
    import json
    import math
    from pathlib import Path

    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.ops.fused_xent import fused_xent_bwd, fused_xent_fwd
    from elephas_tpu_torch.utils import to_simple_rdd

    path = Path(__file__).resolve().parents[1] / "elephas_tpu_torch" / "configs" / \
        "mnist_mlp_logits.json"
    rng = np.random.default_rng(3)
    n, W, E, B, split = 1000, 2, 2, 64, 0.1
    x = rng.random((n, 784)).astype(np.float32)
    # labels a balanced function of the rows: with random labels (or one
    # dominant class) the summed merge of two asynchronous workers leaves
    # an epoch's loss free to rise
    y = np.eye(10, dtype=np.float32)[((x - 0.5) @ rng.normal(size=(784, 10))).argmax(1)]
    sm = SparkModel(path.read_text(), frequency=frequency, num_workers=W, port=0,
                    device="cuda")
    fused_xent_fwd.launches = fused_xent_bwd.launches = 0
    sm.fit(to_simple_rdd(SparkContext(f"local[{W}]"), x, y), epochs=E, batch_size=B,
           validation_split=split)
    per = n // W
    if frequency == "epoch":
        n_train = math.floor(per * (1 - split))
        s, sv = -(-n_train // B), -(-(per - n_train) // B)
    else:
        s, sv = (per - int(per * split)) // B, 0
    assert fused_xent_bwd.launches == W * E * s
    assert fused_xent_fwd.launches == W * E * (s + sv)
    assert all(h["loss"][-1] < h["loss"][0] for h in sm.training_histories)


# -- the Keras layers of the repo's examples (the card has no Keras: the
# models are Keras-3 JSON configs written out here) ---------------------------


def _sequential(input_shape, *layers):
    """A Keras-3 Sequential JSON config: ``layers`` are ``(class_name,
    config)`` pairs, each config with its ``name``."""
    return {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, *input_shape]}},
        *({"class_name": c, "config": cfg} for c, cfg in layers)]}}


LAYER_CASES = [
    ("conv2d_same_stride2", (9, 7, 3), [("Conv2D", dict(
        name="c", filters=8, kernel_size=[3, 3], strides=[2, 2], padding="same",
        activation="relu"))]),
    ("conv2d_dilated", (9, 7, 3), [("Conv2D", dict(
        name="c", filters=4, kernel_size=[3, 2], dilation_rate=[2, 1]))]),
    ("max_pool_same", (9, 7, 3), [("MaxPooling2D", dict(
        name="p", pool_size=[3, 3], strides=[2, 2], padding="same"))]),
    ("conv1d_causal", (11, 3), [("Conv1D", dict(
        name="c", filters=5, kernel_size=[3], padding="causal", dilation_rate=[2]))]),
    ("batch_norm", (5, 4, 6), [("BatchNormalization", dict(name="bn"))]),
    ("reshape", (24,), [("Reshape", dict(name="r", target_shape=[-1, 4])),
                        ("Dense", dict(name="d", units=3))]),
    ("embedding", (9,), [("Embedding", dict(name="e", input_dim=13, output_dim=4))]),
    ("lstm_sequences", (8, 3), [("LSTM", dict(name="l", units=6, return_sequences=True))]),
    ("lstm_last", (8, 3), [("LSTM", dict(name="l", units=6))]),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_keras_layer_on_card_matches_cpu(cuda, case):
    """Each layer over a stack of 3 replicas in training (batch moments and
    moved statistics for BatchNormalization) and in inference, and the
    gradients of a weighted sum of its output, on the card against the same
    layer on the CPU from the same weights: within 1e-5 relative to each
    tensor's scale (float32; cuDNN sums in other orders than the CPU)."""
    from elephas_tpu_torch.models import KerasModelAdapter

    name, shape, layers = case
    cfg = _sequential(shape, *layers)
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 13, size=(3, 7) + shape).astype(np.float32) if name == "embedding"
         else rng.normal(1.0, 2.0, size=(3, 7) + shape).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        adapter = KerasModelAdapter(cfg, seed=4, device=dev)
        tv, ntv = ({k: v[None].expand((3,) + tuple(v.shape)).clone() for k, v in d.items()}
                   for d in adapter.state_values())
        leaves = {k: v.requires_grad_() for k, v in tv.items()}
        xt = torch.from_numpy(x).to(dev)
        y, ntv2 = adapter.stateless_call(leaves, ntv, xt, training=True)
        w = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32)).to(dev) \
            if dev == "cpu" else out["cpu"]["w"].to(dev)
        grads = torch.autograd.grad((y * w).sum(), list(leaves.values())) if leaves else ()
        with torch.no_grad():
            infer = adapter.stateless_call(tv, ntv, xt, training=False)[0]
        out[dev] = {"w": w, "y": y.detach(), "infer": infer, "grads": grads,
                    "ntv": list(ntv2.values())}
    for key in ("y", "infer"):
        want = out["cpu"][key]
        assert (out["cuda"][key].cpu() - want).abs().max() <= 1e-5 * max(want.abs().max(), 1.0)
    for got, want in list(zip(out["cuda"]["grads"], out["cpu"]["grads"])) + list(
            zip(out["cuda"]["ntv"], out["cpu"]["ntv"])):
        assert (got.cpu() - want).abs().max() <= 1e-5 * max(want.abs().max(), 1.0)


def test_embedding_refuses_ids_out_of_range_on_card(cuda):
    """An id outside ``[0, input_dim)`` raises before the gather, where on
    the card it would fault the device."""
    from elephas_tpu_torch.models import KerasModelAdapter

    adapter = KerasModelAdapter(_sequential((4,), ("Embedding", dict(
        name="e", input_dim=10, output_dim=3))), device="cuda")
    ok = np.array([[0, 9, 3, 2]], np.float32)
    assert adapter.predict(ok).shape == (1, 4, 3)
    for bad in (10.0, -1.0):
        x = ok.copy()
        x[0, 2] = bad
        with pytest.raises(ValueError, match=r"\[0, 10\)"):
            adapter.predict(x)
    torch.cuda.synchronize()


def _blobs(n, seed=8):
    """MNIST-shaped class blobs: ten prototypes in [0, 1]^784 with noise,
    clipped; one-hot labels."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, size=(10, 784))
    labels = rng.integers(0, 10, size=n)
    x = np.clip(protos[labels] + 0.3 * rng.normal(size=(n, 784)), 0, 1)
    return x.astype(np.float32), np.eye(10, dtype=np.float32)[labels]


def test_batchnorm_cnn_steps_and_fit_on_card_match_cpu(cuda):
    """The committed BatchNormalization CNN (``mnist_cnn_bn.json``) on the
    card against the CPU from the same weights: one train step over 3
    replicas and one gradient-synchronous grad step (loss sums, gradients,
    moved statistics; a replica partly padding) within 1e-5 of scale, and a
    synchronous epoch-frequency fit (3 workers, 2 epochs) whose loss and
    accuracy histories are within 1e-4. The fit's weights are not compared:
    Adam steps a parameter whose gradient is near zero (a dense kernel's
    row fed by a feature the ReLU and BatchNormalization hold near
    constant) by the learning rate in the direction of that gradient's
    rounding, so the card's and the CPU's weights part while every step
    computes the same gradients to 1e-6 (``chip_smoke.py``'s
    ``fit_layers_cross_check`` prints both, one step apart, on an H100:
    4e-4 of a dense kernel's scale, 3e-3 of a convolution bias's)."""
    from pathlib import Path

    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.models import KerasModelAdapter
    from elephas_tpu_torch.utils import to_simple_rdd

    text = (Path(__file__).resolve().parents[1] / "elephas_tpu_torch" / "configs" /
            "mnist_cnn_bn.json").read_text()
    x, y = _blobs(288)
    L, B = 3, 32
    sw = torch.ones(L, B)
    sw[2, 20:] = 0.0
    steps = {}
    for dev in ("cuda", "cpu"):
        a = KerasModelAdapter(text, device=dev)
        tv, ntv = a.state_values()
        stack = {k: v[None].expand((L,) + tuple(v.shape)).clone() for k, v in tv.items()}
        nstack = {k: v[None].expand((L,) + tuple(v.shape)).clone() for k, v in ntv.items()}
        xs = torch.from_numpy(x[:L * B].reshape(L, B, 784)).to(dev)
        ys = torch.from_numpy(y[:L * B].reshape(L, B, 10)).to(dev)
        opt = a.make_optimizer()
        _, ntv2, _, st = a.build_train_step(opt)(
            stack, nstack, opt.init(stack, count_shape=(L,)), xs, ys, sw.to(dev), None)
        grads, gntv, gst = a.build_grad_step()(tv, nstack, xs, ys, sw.to(dev), None)
        steps[dev] = [t.cpu() for t in (*ntv2.values(), *st, *grads.values(), *gntv.values(),
                                        *gst)]
    for got, want in zip(steps["cuda"], steps["cpu"]):
        assert (got - want).abs().max() <= 1e-5 * max(want.abs().max(), 1e-6)
    out = {}
    for dev in ("cuda", "cpu"):
        sm = SparkModel(text, mode="synchronous", num_workers=3, device=dev)
        sm.fit(to_simple_rdd(SparkContext("local[3]"), x, y), epochs=2, batch_size=32,
               validation_split=0.1)
        out[dev] = sm.training_histories[-1]
    for k, v in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][k], v, rtol=1e-4, atol=1e-4)


# -- the API skins: the Spark-ML estimator and the search on the card ----------------


def test_estimator_over_the_logits_mlp_launches_k1_exactly(cuda):
    """``ElephasEstimator`` over the committed MNIST MLP JSON (a logits
    head) on a DataFrame, synchronous, ``"jax"``, 3 workers: exactly E (S +
    Sv) K1-fwd and E S K1-bwd launches and no other kernel; the transformed
    ``prediction`` column is the argmax of the trained weights' predictions
    on the card, exactly."""
    import json
    from pathlib import Path

    from elephas_tpu_torch import ElephasEstimator, ElephasTransformer
    from elephas_tpu_torch.data import Row, SparkSession, SparkContext
    from elephas_tpu_torch.mllib import Vectors
    from elephas_tpu_torch.models import KerasModelAdapter

    text = (Path(__file__).resolve().parents[1] / "elephas_tpu_torch" / "configs" /
            "mnist_mlp_logits.json").read_text()
    cc = json.loads(text)["compile_config"]
    x, y = _blobs(960)
    W, E, B, split = 3, 2, 32, 0.1
    spark = SparkSession(SparkContext(f"local[{W}]"))
    df = spark.createDataFrame([Row(features=Vectors.dense(a.astype("float64")),
                                    label=float(b.argmax())) for a, b in zip(x, y)])
    est = ElephasEstimator(keras_model_config=text, optimizer_config=cc["optimizer"],
                           loss=cc["loss"], metrics=["accuracy"], categorical=True,
                           nb_classes=10, num_workers=W, epochs=E, batch_size=B,
                           validation_split=split, mode="synchronous",
                           parameter_server_mode="jax")
    fused_xent_fwd.launches = fused_xent_bwd.launches = 0
    tr = est.fit(df)
    per = 960 // W
    n_val = int(per * split)
    s, sv = -(-(per - n_val) // B), -(-n_val // B)
    assert fused_xent_bwd.launches == E * s
    assert fused_xent_fwd.launches == E * (s + sv)
    assert isinstance(tr, ElephasTransformer) and tr.get_model().device.type == "cuda"
    got = np.array([r.prediction for r in tr.transform(df).collect()])
    want = KerasModelAdapter(text, weights=tr.weights, device="cuda").predict(x).argmax(1)
    np.testing.assert_array_equal(got, want)
    assert fused_xent_fwd.launches == E * (s + sv)      # predictions launch no K1


class _PinProbe:
    def __init__(self, current):
        self.current = current

    def to_json(self):
        return "{}"

    def get_weights(self):
        return [np.zeros(1, np.float32)]


def _probe_data():
    return (None,) * 4


def _probe_model(x_train, y_train, x_test, y_test):
    return {"loss": {{uniform(0.0, 1.0)}}, "status": "ok",
            "model": _PinProbe(torch.cuda.current_device())}


def test_search_pins_each_worker_to_its_card(cuda, monkeypatch):
    """``HyperParamModel`` on ``"cuda"``: each worker thread runs its trials
    with ``partitionId % device_count`` as its current device, and each
    trial records it (on one card: every worker ``cuda:0``)."""
    import elephas_tpu_torch.hyperparam as hyperparam
    from elephas_tpu_torch import HyperParamModel
    from elephas_tpu_torch.data import SparkContext

    seen = []
    real = hyperparam.HyperasWorker._run_trials

    def run_trials(self, data_iterator):
        trials = real(self, data_iterator)
        seen.append(torch.cuda.current_device())
        return trials

    monkeypatch.setattr(hyperparam.HyperasWorker, "_run_trials", run_trials)
    W, evals, n = 4, 2, torch.cuda.device_count()
    trials = HyperParamModel(SparkContext(f"local[{W}]"), W).compute_trials(
        _probe_model, _probe_data, evals)
    assert len(trials) == W * evals
    for i, t in enumerate(trials):
        pinned = (i // evals) % n
        assert t["device"] == f"cuda:{pinned}"
    assert sorted(seen) == sorted(p % n for p in range(W))


# -- sliding windows at Mistral-7B's head shapes; beam search -------------------

MISTRAL_HEADS = dict(H=32, Hkv=8, Dh=128)


@pytest.mark.parametrize("window", [64, 1000])
def test_windowed_rope_kernels_match_plain_at_mistral_heads(cuda, window):
    """K2-fwd, dq and dkv with rope on load and a sliding window at
    Mistral-7B's heads (32 query, 8 KV, Dh 128), T 2048, within 2e-5 of
    their plain versions."""
    rng = np.random.default_rng(window)
    H, Hkv, Dh, T = MISTRAL_HEADS["H"], MISTRAL_HEADS["Hkv"], MISTRAL_HEADS["Dh"], 2048
    q, k, v, do = _t(rng, 1, T, H, Dh), _t(rng, 1, T, Hkv, Dh), _t(rng, 1, T, Hkv, Dh), \
        _t(rng, 1, T, H, Dh)
    c2, s2 = make_rope_tables(*_rope_angles(torch.arange(T, device="cuda")[None], Dh))
    o, lse = flash_attention_rope_fwd(q, k, v, c2, s2, True, window)
    wo, wl = rope_attention_fwd_reference(q, k, v, c2, s2, True, window)
    torch.testing.assert_close(o, wo, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, wl, atol=2e-5, rtol=2e-5)
    delta = (do * wo).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, wl, delta, c2, s2, True, window)
    want = rope_attention_bwd_reference(*args)
    for got, w in zip((flash_attention_rope_dq(*args), *flash_attention_rope_dkv(*args)), want):
        torch.testing.assert_close(got, w, atol=2e-5, rtol=2e-5)


def test_ring_decode_matches_plain_at_mistral_heads(cuda):
    """K4 on a rolling cache of aligned(4096 + 1) = 4352 slots at every
    phase of the ring: before the wrap, at it, past it, and one row far
    behind another."""
    rng = np.random.default_rng(3)
    T, Hkv, G, Dh = 4352, 8, 4, 128
    for pos in ([4000, 4095], [4096, 4351], [4352, 4700], [5, 9000]):
        q, k, v = _t(rng, 2, Hkv, G, Dh), _t(rng, 2, Hkv, T, Dh), _t(rng, 2, Hkv, T, Dh)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        got = flash_decode_lse(q, k, v, p, window=4096, ring=True)
        want = decode_attention_reference_lse(q, k, v, p, 4096, True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C", [None, 300], ids=["decode", "chunk"])
def test_windowed_paged_kernels_match_plain_at_mistral_heads(cuda, C):
    """K5-decode and K5-chunk with a window of 4096 at positions past it,
    Mistral-7B's KV heads, page 16."""
    rng = np.random.default_rng(5)
    S, Hkv, G, Dh, page, M = 2, 8, 4, 128, 16, 300
    P = S * M + 1
    kp, vp = _t(rng, P, Hkv, page, Dh), _t(rng, P, Hkv, page, Dh)
    table = torch.from_numpy((1 + rng.permutation(S * M)).reshape(S, M).astype(np.int32)).cuda()
    pos = torch.tensor([4200, 4500], dtype=torch.int32, device="cuda")
    if C is None:
        q = _t(rng, S, Hkv, G, Dh)
        got = paged_flash_decode_lse(q, kp, vp, table, pos, page, 4096)
        want = paged_decode_reference_lse(q, kp, vp, table, pos, page, 4096)
    else:
        q = _t(rng, S, Hkv, G, C, Dh)
        got = (paged_flash_chunk(q, kp, vp, table, pos, page, 4096),)
        want = (paged_chunk_reference(q, kp, vp, table, pos, page, 4096),)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


WINDOWED_LM = dict(vocab=97, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=256,
                   max_len=256, pos_encoding="rotary", norm="rmsnorm", activation="swiglu",
                   ffn_bias=False, attn_bias=False)


def _greedy_agrees_with_dense_apply(model, params, out, t0):
    """Each row's generated tokens equal the dense teacher-forced argmax up
    to its first near tie (top-2 gap 1e-3)."""
    seq = out[:, :-1].long()
    pos = torch.arange(seq.shape[1], device="cuda").expand_as(seq)
    with torch.no_grad():
        logits = model.apply(params, seq, pos, attn="dense")[:, t0 - 1:]
    top = torch.topk(logits, 2, dim=-1).values
    gaps, want = (top[..., 0] - top[..., 1]).cpu(), logits.argmax(-1).cpu()
    got = out[:, t0:].cpu()
    compared = 0
    for r in range(got.shape[0]):
        n = 0
        while n < got.shape[1] and float(gaps[r, n]) > 1e-3:
            assert int(got[r, n]) == int(want[r, n]), (r, n)
            n += 1
        compared += n
    return compared


@pytest.mark.parametrize("windows", [16, (16, None)], ids=["ring", "mixed"])
def test_windowed_generate_on_card_matches_dense_apply(cuda, windows):
    """Greedy ``generate`` past the window (and, all-windowed, past the
    ring's wrap: 48 decode steps over a ring of 24 slots) against the
    card's own ``apply(attn="dense")`` at every generated position. The
    seeds are chosen so that no top-2 gap of either model falls under 1e-2
    on the CPU, so no near tie can end the comparison early."""
    model = TransformerLM(**WINDOWED_LM, attn_window=windows, device="cuda")
    params = model.init(9)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 97, size=(2, 40))).cuda()
    out = model.generate(params, prompt, 48)
    assert _greedy_agrees_with_dense_apply(model, params, out, 40) == 2 * 48


def test_beam1_equals_generate_on_card(cuda):
    """``generate_beam(beam_size=1)`` is greedy ``generate`` bit for bit on
    the card (its candidates ranked in float64), and a wider beam keeps
    the prompt and finite scores."""
    from elephas_tpu_torch.models import generate_beam

    model = TransformerLM(**dict(WINDOWED_LM, attn_window=16), device="cuda")
    params = model.init(4)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, 97, size=(3, 20))).cuda()
    got, _ = generate_beam(model, params, prompt, 30, beam_size=1)
    assert torch.equal(got, model.generate(params, prompt, 30))
    wide, scores = generate_beam(model, params, prompt, 30, beam_size=4)
    assert torch.equal(wide[:, :20], prompt.to(torch.int32))
    assert bool(torch.isfinite(scores).all())


# -- multi-tenant LoRA serving and LoRA training ----------------------------------

MT_CFG = dict(vocab=97, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128,
              max_len=96, activation="swiglu", norm="rmsnorm", attn_bias=False,
              ffn_bias=False, pos_encoding="rotary", n_adapters=3, lora_rank=4,
              lora_targets=("q", "k", "v", "o"))


@pytest.mark.parametrize("spec", [1, 4], ids=["plain", "speculative"])
def test_multi_tenant_engine_on_card(cuda, spec):
    """Co-batched tenants on the paged engine on the card: exact K5 (and
    the self-drafter's K4) launch counts; adapter 0 equals the base paged
    engine on the card token for token; each tenant equals a dense engine
    on its merged weights and the CPU's multi-tenant engine up to near
    ties; kv.check()."""
    from elephas_tpu_torch.serving import ModelDrafter

    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in (13, 30, 21, 9, 17, 25)]
    out = {}
    for dev in ("cpu", "cuda"):
        mt = MultiTenantLM(**MT_CFG, device=dev)
        p = mt.randomize_adapter(mt.randomize_adapter(mt.init(2), 1, seed=3), 2, seed=4)
        dr = ModelDrafter(mt, p) if spec > 1 else None
        eng = ServingEngine(mt, p, n_slots=4, paged=True, page_size=8, device=dev,
                            speculate_k=spec, drafter=dr)
        for c in (flash_decode_lse, paged_flash_decode_lse, paged_flash_chunk):
            c.launches = 0
        ids = [eng.submit(q, 16, adapter_id=i % 3) for i, q in enumerate(prompts)]
        fin = eng.drain()
        eng.kv.check()
        out[dev] = [fin[i].tokens for i in ids]
    snap = eng.snapshot()
    rounds = snap["fastpath"].get("spec_rounds", 0)
    steps = snap["engine"]["decode_steps"] - rounds
    inserts = snap["engine"]["prefills"]
    L = MT_CFG["n_layers"]
    d_steps = dr.steps if dr else 0
    assert (flash_decode_lse.launches, paged_flash_decode_lse.launches,
            paged_flash_chunk.launches) == (L * d_steps, L * steps, L * (inserts + rounds))
    if dr:
        assert snap["fastpath"]["spec_accepted"] == snap["fastpath"]["spec_drafted"] > 0
    base = mt.base_model()
    basep = {k: v for k, v in p.items() if not k.startswith("lora_")}
    beng = ServingEngine(base, basep, n_slots=4, paged=True, page_size=8, device="cuda")
    bids = [beng.submit(q, 16) for q in prompts[::3]]
    bfin = beng.drain()
    assert [bfin[i].tokens for i in bids] == out["cuda"][::3]         # adapter 0
    compared = 0
    for i, q in enumerate(prompts):
        merged = mt.merged_params(p, i % 3)
        ref = ServingEngine(base, merged, n_slots=1, device="cuda")
        rid = ref.submit(q, 16)
        want = ref.drain()[rid].tokens
        compared += _near_tie_agree(base, merged, [q], [out["cuda"][i]], [want])
        compared += _near_tie_agree(base, merged, [q], [out["cuda"][i]], [out["cpu"][i]])
    assert compared > 0


def test_lora_train_step_on_card_matches_cpu(cuda):
    """A rotary GQA model's LoRA step on ``attn="flash"``: the card (the
    rope-on-load kernels, L launches of each, none of the plain K2) against
    the CPU from the same weights and factors; loss rtol 1e-4, every factor
    gradient within 1e-3 of its scale; one step moves every ``b`` and
    leaves every frozen tensor the same object."""
    cfg = {k: v for k, v in MT_CFG.items() if not k.startswith(("n_adapters", "lora"))}
    batch = make_lm_batches(np.random.default_rng(15).integers(0, 97, size=(2, 65)))
    out = {}
    for dev in ("cpu", "cuda"):
        model = TransformerLM(**cfg, device=dev)
        lp = apply_lora(model.init(4), keys=("wq", "wk", "wv", "wo"), rank=4)
        lp = {k: (type(v)(v.w, v.a, torch.full_like(v.b, 0.01), v.alpha)
                  if hasattr(v, "materialize") else v) for k, v in lp.items()}
        step, opt_init = build_lora_lm_train_step(model, None, adam(1e-3), attn="flash")
        counters = (flash_attention_rope_fwd, flash_attention_rope_dq,
                    flash_attention_rope_dkv, flash_attention_fwd)
        before = [f.launches for f in counters]
        loss, grads = step.grad(lp, *batch)
        if dev == "cuda":
            assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 2, 0]
            new, _, _ = step(lp, opt_init(lp), *batch)
            for k, v in lp.items():
                if hasattr(v, "materialize"):
                    assert new[k].w is v.w and not torch.equal(new[k].b, v.b)
                else:
                    assert new[k] is v
        out[dev] = (float(loss), {f"{k}.{f}": getattr(g, f).cpu()
                                  for k, g in grads.items() if g is not None
                                  for f in ("a", "b")})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    assert len(out["cpu"][1]) == 8
    for k_, w in out["cpu"][1].items():
        err = float((out["cuda"][1][k_] - w).abs().max())
        assert err <= 1e-3 * max(float(w.abs().max()), 1e-6), k_


# -- resilience, streaming and the serving fleet ------------------------------

FLEET_LM = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=128)


def _gaps(model, params, prompt, tokens, temperature=0.0, seed=0):
    """Top-1 minus top-2 at each generated position from one teacher-forced
    pass (for a sampled row, of the scaled logits plus the engine's
    (seed, position) Gumbel noise)."""
    from elephas_tpu_torch.models.transformer import _gumbel

    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)]).astype(np.int64)
    dev = params["tok"].device
    with torch.no_grad():
        logits, _ = model.decode_chunk(params, torch.from_numpy(seq)[None].to(dev), 0,
                                       model.init_cache(1, len(seq)))
        scores = logits[0, len(prompt) - 1:].float()
        if temperature > 0:
            n = scores.shape[0]
            pos = torch.arange(len(prompt), len(prompt) + n, device=dev)
            scores = scores / temperature + _gumbel(
                torch.full((n,), seed, dtype=torch.int64, device=dev), pos, scores.shape[-1])
        top = torch.topk(scores, 2, dim=-1).values.cpu()
    return (top[:, 0] - top[:, 1]).tolist()


def _equal_up_to_near_ties(a, b, gaps):
    n = 0
    while n < len(b) and gaps[n] > 1e-3:
        assert a[n] == b[n], (n, a, b)
        n += 1
    return n


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fleet_kill_join_on_card_matches_undisturbed_and_cpu(cuda, paged):
    """Two partitions on the card, the reference chaos scenario's trace
    (seed 3, half sampled) at this model's vocabulary: partition 0 killed
    at 2.0 s, a replacement joining at 2.5 s. Every request terminal, the
    same placements, migrations and finish times as the same fleet on the
    CPU, ``kv.check()`` after every fleet step when paged, and every stream
    (migrated or not) equal to the undisturbed card run's up to its first
    near tie."""
    from elephas_tpu_torch.fleet import FleetRouter, SimClock, TrafficModel

    model = TransformerLM(**FLEET_LM, device=cuda)
    params = model.init(4)
    trace = TrafficModel(seed=3, base_rps=4.0, duration_s=6.0, n_tenants=4,
                         sampled_frac=0.5, burst_amp=2.0, vocab=97).generate()
    chaos = [{"t": 2.0, "op": "kill", "pid": 0}, {"t": 2.5, "op": "join"}]

    def replay(m, p, dev, events):
        clock = SimClock()
        router = FleetRouter(lambda pid: ServingEngine(m, p, n_slots=4, paged=paged,
                                                       page_size=8, clock=clock,
                                                       perf_clock=clock, device=dev),
                             2, clock=clock, lease_s=0.5)
        pending, i, e = list(trace), 0, 0
        while True:
            while e < len(events) and events[e]["t"] <= clock():
                ev = events[e]
                e += 1
                (router.kill_partition(ev["pid"]) if ev["op"] == "kill"
                 else router.join_partition())
            while i < len(pending) and pending[i].arrival_s <= clock():
                router.submit(pending[i])
                i += 1
            router.step()
            if paged:
                for pid in router.partition_ids():
                    router._engines[pid].kv.check()
            if i == len(pending) and e == len(events) and not router.active:
                return router
            clock.advance(0.05)

    base = replay(model, params, cuda, [])
    card = replay(model, params, cuda, chaos)
    cpu_model = TransformerLM(**FLEET_LM, device="cpu")
    cpu = replay(cpu_model, {k: v.cpu() for k, v in params.items()}, "cpu", chaos)
    got, want, ref = card.results(), base.results(), cpu.results()
    assert len(got) == len(trace) and card.migrations == cpu.migrations >= 1
    for r in trace:
        st = got[r.request_id]
        assert (st.partition, st.migrations, st.finish_reason, st.finished_at) == (
            ref[r.request_id].partition, ref[r.request_id].migrations,
            ref[r.request_id].finish_reason, ref[r.request_id].finished_at)
        gaps = _gaps(model, params, np.asarray(r.prompt, np.int32),
                     want[r.request_id].tokens, r.temperature, r.seed)
        _equal_up_to_near_ties(st.tokens, want[r.request_id].tokens, gaps)


def test_fit_stream_into_paged_engine_on_card(cuda):
    """``SparkModel.fit_stream`` over a socket server with the LM train
    step (``attn="flash"``) as ``train_fn``, publishing each commit into a
    live paged engine on the card: the engine's version follows each
    publish, a probe after each swap equals a fresh engine on the published
    weights up to near ties, and each train step launched L of each flash
    attention kernel and 2L+1 K3-bwd."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.streaming import engine_sink, list_to_params, params_to_list

    model = TransformerLM(**FLEET_LM, device=cuda)
    p0 = model.init(6)
    L = FLEET_LM["n_layers"]
    step, opt_init = build_lm_train_step(model, None, adam(1e-2), attn="flash")
    state, launches = {}, []
    kernels = (flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
               fused_layer_norm_bwd)

    def train_fn(weights, batch):
        for k in kernels:
            k.launches = 0
        params = list_to_params(weights, p0)
        state.setdefault("opt", opt_init(params))
        new, state["opt"], loss = step(params, state["opt"], *batch)
        launches.append([k.launches for k in kernels])
        return params_to_list(new), float(loss)

    class Holder:
        def __init__(self, params):
            self.params = params

        def get_weights(self):
            return params_to_list(self.params)

        def set_weights(self, weights):
            self.params = list_to_params(weights, self.params)

    rng = np.random.default_rng(1)
    batches = [tuple(torch.from_numpy(a).to(cuda) for a in
                     make_lm_batches(rng.integers(0, 97, size=(4, 65)).astype(np.int32)))
               for _ in range(3)]
    eng = ServingEngine(model, p0, n_slots=4, paged=True, page_size=8, device=cuda)
    live = eng.submit(rng.integers(0, 97, size=20).astype(np.int32), 60)
    eng.step()
    probe = rng.integers(0, 97, size=12).astype(np.int32)
    seen = []

    def sink(weights, version):
        engine_sink(eng, p0)(weights, version)
        assert eng.weights_version == version
        rid = eng.submit(probe, 8)
        while eng.result(rid, pop=False) is None:
            eng.step()
        got = eng.result(rid).tokens
        published = list_to_params(weights, p0)
        fresh = ServingEngine(model, published, n_slots=1, paged=True, page_size=8,
                              device=cuda)
        fid = fresh.submit(probe, 8)
        want = fresh.drain()[fid].tokens
        seen.append((version, _equal_up_to_near_ties(got, want,
                                                     _gaps(model, published, probe, want))))

    sm = SparkModel(Holder(p0), mode="asynchronous", parameter_server_mode="socket",
                    port=0, device=cuda)
    summary = sm.fit_stream(batches, train_fn, sink=sink, publish_every=1)
    assert summary["commits"] == 3 and [v for v, _ in seen] == [1, 2, 3]
    assert launches == [[L, L, L, 2 * L + 1]] * 3
    eng.drain()
    assert eng.result(live) is not None


def test_fault_injected_host_fit_launches_k1_exactly(cuda):
    """The MNIST MLP's JSON through the host path over a socket server
    under a fault plan: partition 1 crashes at its second push (after two
    epochs) and its retry trains again, pushes are dropped at a rate, a
    retry policy wraps the client. K1 launched exactly for every epoch
    trained (the crashed attempt's included), no other kernel, and the
    server applied every push that was not dropped exactly once."""
    import json
    import math
    from pathlib import Path

    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.ops.fused_xent import fused_xent_bwd, fused_xent_fwd
    from elephas_tpu_torch.resilience import FaultPlan, RetryPolicy
    from elephas_tpu_torch.resilience.faults import _unit
    from elephas_tpu_torch.utils import to_simple_rdd

    path = Path(__file__).resolve().parents[1] / "elephas_tpu_torch" / "configs" / \
        "mnist_mlp_logits.json"
    rng = np.random.default_rng(3)
    n, W, E, B, split = 1000, 2, 2, 64, 0.1
    x = rng.random((n, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[((x - 0.5) @ rng.normal(size=(784, 10))).argmax(1)]
    pushes, rate = W * E + 1, 0.3
    seed = next(s for s in range(100)
                if any(_unit(s, "drop_push", i) < rate for i in range(pushes)))
    drops = sum(_unit(seed, "drop_push", i) < rate for i in range(pushes))
    plan = FaultPlan(seed, drop_push=rate, crash_partition=1, crash_after_pushes=1)
    sm = SparkModel(path.read_text(), num_workers=W, port=0, device=cuda,
                    parameter_server_mode="socket", fault_plan=plan,
                    retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0))
    fused_xent_fwd.launches = fused_xent_bwd.launches = 0
    sm.fit(to_simple_rdd(SparkContext(f"local[{W}]"), x, y), epochs=E, batch_size=B,
           validation_split=split)
    per = n // W
    n_train = math.floor(per * (1 - split))
    s, sv = -(-n_train // B), -(-(per - n_train) // B)
    epochs = W * E + E
    assert "crash-partition-1" in plan.fired
    assert fused_xent_bwd.launches == epochs * s
    assert fused_xent_fwd.launches == epochs * (s + sv)
    ps = sm.membership_snapshot()["parameter_servers"]["primary"]
    assert ps["version"] == pushes - drops and ps["rejected_stale"] == 0
    for w in sm.master_network.get_weights():
        assert np.isfinite(w).all()
    json.dumps(plan.fired)
