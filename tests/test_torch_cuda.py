"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving and training runs do not reach (scalar-load
head dims, odd group sizes, caches and sequences shorter than a tile,
every mask mode), the wrappers' refusals, and the serving engine, the
train step and ``generate`` on the card against the same code on the CPU.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import). This file imports no JAX, so it runs on a machine
with only PyTorch: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                      build_lm_train_step, make_lm_batches)
from elephas_tpu_torch.ops.flash_attention import (
    attention_bwd_reference, attention_fwd_reference, flash_attention,
    flash_attention_dkv, flash_attention_dq, flash_attention_fwd)
from elephas_tpu_torch.ops.flash_decode import (decode_attention_reference_lse,
                                                flash_decode_lse)
from elephas_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                              fused_layer_norm_bwd,
                                              layer_norm_reference)
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
                                   (1100, 64)])
def test_layer_norm_bwd_kernel_matches_plain(cuda, shape):
    """K3-bwd against autograd through the plain version; (1100, 64) gives
    the pass-1 blocks more than one row each. atol/rtol 1e-4."""
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


@pytest.mark.parametrize("B,T,H,Hkv,Dh", [
    (1, 1, 1, 1, 6),          # one position, a tiny head dim
    (2, 37, 4, 2, 64),        # shorter than a tile, grouped-query
    (1, 130, 3, 1, 100),      # ragged tiles, MQA, Dh class 128
    (1, 70, 2, 2, 256),       # the widest head dim
])
@pytest.mark.parametrize("mode", ["causal", "window", "full"])
def test_flash_attention_kernels_match_plain(cuda, B, T, H, Hkv, Dh, mode):
    """K2-fwd, K2-dq and K2-dkv against their plain versions on the same
    lse and delta; atol/rtol 2e-5 as the reference pins its kernels."""
    rng = np.random.default_rng(6)
    q, do = _t(rng, B, T, H, Dh), _t(rng, B, T, H, Dh)
    k, v = _t(rng, B, T, Hkv, Dh), _t(rng, B, T, Hkv, Dh)
    causal, window = mode != "full", (max(1, T // 3) if mode == "window" else None)
    o, lse = flash_attention_fwd(q, k, v, causal, window)
    wo, wl = attention_fwd_reference(q, k, v, causal, window)
    torch.testing.assert_close(o, wo, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, wl, atol=2e-5, rtol=2e-5)
    delta = (do * wo).sum(-1).transpose(1, 2).contiguous() - 0.25
    got = (flash_attention_dq(q, k, v, do, wl, delta, causal, window),
           *flash_attention_dkv(q, k, v, do, wl, delta, causal, window))
    want = attention_bwd_reference(q, k, v, do, wl, delta, causal, window)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)


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
