"""Kernels of the port: each a hand-written CUDA kernel with its plain
PyTorch version beside it (the CPU path and the oracle)."""

from .flash_attention import (attention_bwd_reference, attention_fwd_reference,
                              attention_reference, flash_attention,
                              flash_attention_dkv, flash_attention_dq,
                              flash_attention_fwd, flash_attention_with_lse,
                              repeat_kv_heads)
from .flash_decode import (aligned_cache_length, decode_attention,
                           decode_attention_lse, decode_attention_reference,
                           decode_attention_reference_lse, flash_decode_lse)
from .layer_norm import (fused_layer_norm, fused_layer_norm_bwd, layer_norm,
                         layer_norm_reference)

__all__ = [
    "aligned_cache_length",
    "attention_bwd_reference",
    "attention_fwd_reference",
    "attention_reference",
    "decode_attention",
    "decode_attention_lse",
    "decode_attention_reference",
    "decode_attention_reference_lse",
    "flash_attention",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_fwd",
    "flash_attention_with_lse",
    "flash_decode_lse",
    "fused_layer_norm",
    "fused_layer_norm_bwd",
    "layer_norm",
    "layer_norm_reference",
    "repeat_kv_heads",
]
