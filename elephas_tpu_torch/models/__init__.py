"""Models of the port."""

from .convert import from_jax_params, to_numpy
from .optimizers import (AdamState, FusedOptimizer, GradientTransformation,
                         adam, adam_compact, fused_adam, scale_by_adam_compact)
from .transformer import (MoETransformerLM, MultiTenantLM, TransformerLM,
                          build_lm_eval_step, build_lm_train_step,
                          chunked_summed_xent, make_lm_batches, nucleus_mask,
                          select_slot_tokens, select_tokens)

__all__ = ["AdamState", "FusedOptimizer", "GradientTransformation",
           "MoETransformerLM", "MultiTenantLM", "TransformerLM", "adam",
           "adam_compact", "build_lm_eval_step", "build_lm_train_step",
           "chunked_summed_xent", "from_jax_params", "fused_adam",
           "make_lm_batches", "nucleus_mask", "scale_by_adam_compact",
           "select_slot_tokens", "select_tokens", "to_numpy"]
