"""Models of the port."""

from .adapters import KerasModelAdapter
from .beam import generate_beam
from .convert import from_jax_params, to_numpy
from .losses import resolve_accuracy, resolve_per_sample_loss
from .optimizers import (AdamState, FusedOptimizer, GradientTransformation,
                         adam, adam_compact, fused_adam, scale_by_adam_compact,
                         to_torch_optimizer)
from .transformer import (MoETransformerLM, MultiTenantLM, TransformerLM,
                          build_lm_eval_step, build_lm_train_phases,
                          build_lm_train_step, chunked_summed_xent,
                          make_lm_batches, nucleus_mask, select_slot_tokens,
                          select_tokens)

__all__ = ["AdamState", "FusedOptimizer", "GradientTransformation",
           "KerasModelAdapter", "MoETransformerLM", "MultiTenantLM", "TransformerLM", "adam",
           "adam_compact", "build_lm_eval_step", "build_lm_train_phases",
           "build_lm_train_step", "chunked_summed_xent", "from_jax_params",
           "fused_adam", "generate_beam",
           "make_lm_batches", "nucleus_mask", "resolve_accuracy",
           "resolve_per_sample_loss", "scale_by_adam_compact",
           "select_slot_tokens", "select_tokens", "to_numpy",
           "to_torch_optimizer"]
