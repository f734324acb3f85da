"""Models of the port."""

from .adapters import KerasModelAdapter
from .beam import generate_beam
from .convert import from_jax_params, to_numpy
from .hf_import import lm_from_hf, load_hf_lm
from .losses import resolve_accuracy, resolve_per_sample_loss
from .optimizers import (AdamState, FusedOptimizer, GradientTransformation,
                         adam, adam_compact, fused_adam, masked,
                         scale_by_adam_compact, to_torch_optimizer)
from .transformer import (MoETransformerLM, TransformerLM,
                          build_lm_eval_step, build_lm_train_phases,
                          build_lm_train_step, chunked_summed_xent,
                          make_lm_batches, nucleus_mask, select_slot_tokens,
                          select_tokens)
from .lora import (LoRATensor, MultiTenantLM, apply_lora,
                   build_lora_lm_train_step, load_lora, lora_mask,
                   lora_trainable_count, merge_lora, save_lora)
from .quantize import (QuantizedTensor, dequantize_params, quantize_lm_params,
                       quantized_nbytes)

__all__ = ["AdamState", "FusedOptimizer", "GradientTransformation",
           "KerasModelAdapter", "LoRATensor", "MoETransformerLM", "MultiTenantLM",
           "QuantizedTensor", "TransformerLM", "adam", "adam_compact", "apply_lora",
           "build_lm_eval_step", "build_lm_train_phases", "build_lm_train_step",
           "build_lora_lm_train_step", "chunked_summed_xent", "dequantize_params",
           "from_jax_params", "fused_adam", "generate_beam", "lm_from_hf",
           "load_hf_lm", "load_lora", "lora_mask", "lora_trainable_count",
           "make_lm_batches", "masked", "merge_lora", "nucleus_mask",
           "quantize_lm_params", "quantized_nbytes", "resolve_accuracy",
           "resolve_per_sample_loss", "save_lora", "scale_by_adam_compact", "select_slot_tokens",
           "select_tokens", "to_numpy", "to_torch_optimizer"]
