"""The reference's ``elephas_tpu/ops/pallas_flash.py`` names at the same path.

The port keeps K2 (the flash-attention training kernels, plain and
rope-on-load) in :mod:`elephas_tpu_torch.ops.flash_attention`; this module
re-exports its entries so that code written against the reference's
module path imports them here, with the reference's default block sizes
``_BQ`` and ``_BK`` (the port's entries accept ``block_q`` / ``block_k``
and ignore them: the CUDA kernels pick their own tiles).
"""

from .flash_attention import (flash_attention_rope, flash_attention_tpu,
                              flash_attention_with_lse, make_rope_tables)

_BQ = 512
_BK = 512

__all__ = [
    "flash_attention_rope",
    "flash_attention_tpu",
    "flash_attention_with_lse",
    "make_rope_tables",
]
