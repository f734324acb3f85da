"""The params bridge: named model params <-> flat PS weight lists.

The parameter server speaks ``List[np.ndarray]`` (pickle-friendly, no
device round-trips); the LM/serving stack speaks ``Dict[str, tensor]``
(:meth:`TransformerLM.init`). The bridge is a SORTED-KEY flatten — the
order is a pure function of the key set, so any two processes that agree
on the model config agree on the wire order without exchanging a schema.

Port of ``elephas_tpu/streaming/bridge.py``: :func:`params_to_list` copies
tensors to host numpy (a bfloat16 leaf as its exact float32 values), and
:func:`list_to_params` rebuilds tensors with each template leaf's dtype and
device, so a wire list round-trips bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:   # numpy has no bfloat16: exact widen
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def params_to_list(params: Dict[str, Any]) -> List[np.ndarray]:
    """Flatten a named-params dict to the PS wire order (sorted keys)."""
    return [_to_numpy(params[k]) for k in sorted(params)]


def list_to_params(weights: List[Any],
                   template: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild a named-params dict from PS wire order. ``template``
    supplies the key set, and each leaf's dtype and device; shapes are
    checked leaf-by-leaf so a mismatched model config fails loudly at the
    bridge, not as a garbage forward pass. A numpy template leaf gets the
    wire array back as it is."""
    keys = sorted(template)
    if len(keys) != len(weights):
        raise ValueError(
            f"weight list has {len(weights)} arrays but the params "
            f"template has {len(keys)} keys")
    out: Dict[str, Any] = {}
    for key, w in zip(keys, weights):
        like = template[key]
        want = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
        w = w if isinstance(w, torch.Tensor) else np.asarray(w)
        if tuple(w.shape) != tuple(want):
            raise ValueError(
                f"shape mismatch for {key!r}: wire {tuple(w.shape)} vs "
                f"template {tuple(want)} (model configs disagree?)")
        if isinstance(like, torch.Tensor):
            t = w if isinstance(w, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(w))
            out[key] = t.to(device=like.device, dtype=like.dtype)
        else:
            out[key] = w
    return out
