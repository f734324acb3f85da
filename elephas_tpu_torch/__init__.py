"""PyTorch/CUDA port of ``elephas_tpu`` for NVIDIA Hopper (H100).

The JAX package ``elephas_tpu`` is the reference; this package ports it
slice by slice with the same parameter names, layouts and semantics. Every
Pallas kernel of a ported slice becomes a hand-written CUDA kernel under
``ops/csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

Ported so far: the dense serving path, :class:`~.models.TransformerLM`
(``decode_step`` / ``decode_chunk`` / ``prefill_slot``) under
:class:`~.serving.ServingEngine`, with the fused LayerNorm and flash-decode
kernels; and LM training and generation (``apply``,
``build_lm_train_step``, the optimizers, ``prefill``, ``generate``), with
the flash-attention kernels (forward, dq, dkv) and the LayerNorm backward.

Device policy: every entry point takes ``device=`` and defaults to
``"cuda"``. Without a CUDA device the entry points raise unless the caller
asks for the CPU explicitly; nothing falls back quietly. Kernel wrappers
pick by the tensor they are given: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the kernel or raises.

Isolation: this package imports ``torch`` and ``numpy`` only — never
``jax``, ``keras`` or any ``elephas_tpu`` module (framework-free helpers
it needs are copied).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Raises :class:`RuntimeError` for a CUDA device when CUDA is absent: the
    port never carries on on the CPU unless the caller asked for it. On the
    card, float32 matmuls are pinned to full float32 (no TF32): the JAX
    reference runs them at ``Precision.HIGHEST``, and TF32 keeps only about
    three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                f"pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:   # "cuda" and "cuda:0" must compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


__all__ = ["resolve_device"]
