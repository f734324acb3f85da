"""Carry parameters between the JAX package and the port.

Both packages use the same parameter names and layouts, so conversion is a
per-tensor copy: numpy arrays (what the JAX package's ``init`` returns, or
``np.asarray`` of its device arrays) in, torch tensors out, and back.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def from_jax_params(np_params: Mapping[str, np.ndarray],
                    device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters, as numpy arrays, as torch tensors of
    ``dtype`` on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device=dev, dtype=dtype)
            for k, v in np_params.items()}


def to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameters as numpy arrays (on the host), the form the
    JAX package takes."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
