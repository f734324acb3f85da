"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving run does not reach (scalar-load head dims, odd
group sizes, caches shorter than a tile, every mask mode), and the serving
engine on the card against the same engine on the CPU.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
test, never at import). This file imports no JAX, so it runs on a machine
with only PyTorch: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from elephas_tpu_torch.models import TransformerLM
from elephas_tpu_torch.ops.flash_decode import (decode_attention_reference_lse,
                                                flash_decode_lse)
from elephas_tpu_torch.ops.layer_norm import (fused_layer_norm,
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
