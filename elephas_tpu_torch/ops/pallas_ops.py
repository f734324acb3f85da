"""The reference's ``elephas_tpu/ops/pallas_ops.py`` names at the same path.

The port keeps K1 (the fused classification loss) in
:mod:`elephas_tpu_torch.ops.fused_xent`; this module re-exports its entries
so that code written against the reference's module path imports them
here. The reference's ``is_tpu_backend`` has no counterpart: the port's
dispatchers pick the kernel or its plain version by the tensor's device.
"""

from .fused_xent import (categorical_crossentropy_from_logits,
                         fused_xent_from_logits, xent_from_logits_reference)

__all__ = [
    "categorical_crossentropy_from_logits",
    "fused_xent_from_logits",
    "xent_from_logits_reference",
]
