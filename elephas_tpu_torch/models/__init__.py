"""Models of the port."""

from .convert import from_jax_params, to_numpy
from .transformer import (MoETransformerLM, MultiTenantLM, TransformerLM,
                          select_slot_tokens)

__all__ = ["MoETransformerLM", "MultiTenantLM", "TransformerLM",
           "from_jax_params", "select_slot_tokens", "to_numpy"]
