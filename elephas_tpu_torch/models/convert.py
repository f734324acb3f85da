"""Carry parameters between the JAX package and the port.

Both packages use the same parameter names and layouts, so conversion is a
per-tensor copy: numpy arrays (what the JAX package's ``init`` returns, or
``np.asarray`` of its device arrays) in, torch tensors out, and back. Each
array keeps its dtype. A bfloat16 array (``param_dtype="bfloat16"`` expert
stacks) is a numpy dtype that ``ml_dtypes`` registers; it crosses as its
16 raw bits, so the port needs no ``ml_dtypes`` of its own.

A LoRA-adapted entry crosses as a node: the JAX package's ``LoRATensor``
(anything with ``w``, ``a``, ``b`` and ``alpha``) becomes the port's
:class:`~elephas_tpu_torch.models.lora.LoRATensor` of tensors, and the
port's comes back as a ``LoRATensor`` of numpy arrays, whose parts the JAX
package's node takes as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("numpy has no bfloat16 dtype until ml_dtypes is "
                        "imported (JAX imports it)") from None
    return t.view(torch.int16).numpy().view(bf16)


def _is_lora(v) -> bool:
    return all(hasattr(v, f) for f in ("w", "a", "b", "alpha"))


def _lora_node(v, fn):
    from .lora import LoRATensor

    return LoRATensor(fn(v.w), fn(v.a), fn(v.b), float(v.alpha))


def from_jax_params(np_params: Mapping[str, np.ndarray],
                    device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters, as numpy arrays, as torch tensors on
    ``device``, each in its own dtype (or all cast to ``dtype``); a LoRA
    node as the port's node of tensors."""
    dev = resolve_device(device)

    def conv(v):
        return _to_tensor(v).to(device=dev, dtype=dtype)

    return {k: _lora_node(v, conv) if _is_lora(v) else conv(v)
            for k, v in np_params.items()}


def to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameters as numpy arrays on the host, each in its own
    dtype: the form the JAX package takes; a LoRA node as a node of
    arrays."""
    return {k: _lora_node(v, _to_array) if _is_lora(v) else _to_array(v)
            for k, v in params.items()}
