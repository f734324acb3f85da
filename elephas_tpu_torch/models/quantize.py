"""Weight-only int8 quantization for LM inference (port of
``elephas_tpu/models/quantize.py``).

Post-training, symmetric, per-channel: each matmul weight is stored as int8
with one float32 scale per output channel (the token embedding per vocab
row, so an embedding lookup scales only the rows it gathers). Device
memory for the weights drops ~4x; each use site dequantizes the layer it
reads, so no float copy of the whole model stays resident.

No model-code changes: :func:`quantize_lm_params` returns the same params
dict with the big weights replaced by :class:`QuantizedTensor`, a plain
class (as :class:`~elephas_tpu_torch.models.lora.LoRATensor` is) that
answers the operations the LM applies to a weight and dequantizes there.
Every use dequantizes to IDENTICAL float values (``q`` to float32 times
``s``, then the cast), so ``generate(quantized)`` equals
``generate(dequantized)`` bit for bit; the error against the original
float32 weights is at most half a scale step per element. Every weight
reaches ``torch.matmul`` and the kernel wrappers as a real tensor.

Inference-oriented: training wants float weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# [*, in, out]-shaped matmul weights → scales on the last (output) axis
# (w3 = the swiglu gate's up-projection of hf_import-style models).
_LAST_AXIS_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "head")
# the token embedding [V, D] → scales per vocab row (axis 0), so indexing
# dequantizes only the gathered rows; ``tok.T`` (tied logits) then carries
# per-output-channel scales.
_ROW_AXIS_KEYS = ("tok",)


class QuantizedTensor:
    """int8 values ``q`` + per-channel float32 scales ``s``, on one device;
    dequantizes lazily.

    ``s`` has the SAME rank as ``q`` (reduced axes kept as 1), so plain
    broadcasting dequantizes, and an index or ``unbind`` along a leading
    (layer) axis slices both consistently and stays quantized: a layer
    loop dequantizes one layer at a time. ``row_scaled`` marks the
    embedding layout (scales per leading row), whose index gathers before
    it scales."""

    def __init__(self, q, s, row_scaled: bool):
        self.q = q
        self.s = s
        self.row_scaled = row_scaled

    def tree_flatten(self):
        return (self.q, self.s), self.row_scaled

    @classmethod
    def tree_unflatten(cls, row_scaled, children):
        return cls(*children, row_scaled)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"row_scaled={self.row_scaled})")

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return len(self.q.shape)

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes) + int(self.s.nbytes)

    @property
    def device(self):
        return self.q.device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype a use site reads: :meth:`dequantize`'s default."""
        return torch.float32

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.s).to(dtype)

    # -- the operations the LM applies to its weights --------------------
    def astype(self, dtype: torch.dtype) -> torch.Tensor:
        return self.dequantize(dtype)

    def to(self, *args, **kwargs):
        """``.to(device)`` moves ``q`` and ``s`` (a node); ``.to(dtype)``
        dequantizes in that dtype."""
        dtype, device = kwargs.pop("dtype", None), kwargs.pop("device", None)
        if kwargs:
            raise TypeError(f"QuantizedTensor.to takes a device and a dtype, got "
                            f"{sorted(kwargs)}")
        for arg in args:
            if isinstance(arg, torch.dtype):
                dtype = arg
            else:
                device = arg
        node = self if device is None else QuantizedTensor(
            self.q.to(device), self.s.to(device), self.row_scaled)
        return node if dtype is None else node.dequantize(dtype)

    @property
    def T(self):
        return self.dequantize().T

    def __rmatmul__(self, other):
        return other @ self.dequantize(torch.promote_types(other.dtype, torch.float32))

    def __getitem__(self, idx):
        if self.row_scaled:
            # the embedding layout: gather rows, then scale only them
            return self.q[idx].to(torch.float32) * self.s[idx]
        if self.ndim > 2 and isinstance(idx, (int, np.integer, slice)):
            # a leading (layer) index: both leaves, still quantized; a
            # broadcast scale axis of 1 is indexed as the broadcast would
            s_idx = idx if self.s.shape[0] == self.q.shape[0] else (
                0 if not isinstance(idx, slice) else slice(None))
            return QuantizedTensor(self.q[idx], self.s[s_idx], False)
        return self.dequantize()[idx]

    def unbind(self, dim: int = 0):
        if dim != 0 or self.ndim <= 2:
            return self.dequantize().unbind(dim)
        return [self[i] for i in range(self.q.shape[0])]

    def reshape(self, *shape):
        """Reshapes that only regroup the LEADING dim stay quantized (``s``
        keeps ``q``'s rank, so its leading dim, per-layer scales or a
        broadcast 1, regroups consistently); anything else dequantizes
        first."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = tuple(shape[0])
        qs = tuple(self.q.shape)
        rest = qs[1:]
        if (len(shape) > len(rest) and tuple(shape[-len(rest):]) == rest
                and int(np.prod(shape)) == int(np.prod(qs))):
            lead = tuple(shape[:len(shape) - len(rest)])
            s_lead = lead if self.s.shape[0] == qs[0] else (1,) * len(lead)
            return QuantizedTensor(self.q.reshape(shape),
                                   self.s.reshape(s_lead + tuple(self.s.shape[1:])),
                                   self.row_scaled)
        return self.dequantize().reshape(shape)


def quantize_lm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize a (dense-family) LM param dict for inference.

    Matmul weights and the token embedding become :class:`QuantizedTensor`
    on the weight's device (MoE expert stacks included: their ``w1``/``w2``
    are ``[L, E, in, out]``, scaled per (layer, expert, output channel));
    everything else (norm scales and biases, the positional table, unknown
    keys) passes through untouched. Idempotent: an already-quantized dict
    passes through unchanged. The scales are the reference's
    (``max|w| / 127`` over the input axis, at least ``1e-12 / 127``), and
    ``q`` its round-half-even quotient, clipped to ±127, in the weight's
    own dtype."""
    from .lora import LoRATensor

    out: Dict[str, Any] = {}
    for name, value in params.items():
        if isinstance(value, QuantizedTensor):
            out[name] = value
            continue
        if isinstance(value, LoRATensor):
            raise ValueError(
                f"param {name!r} is a LoRATensor adapter node — call "
                "merge_lora(params) before quantize_lm_params"
            )
        ndim = np.ndim(value)
        if name in _LAST_AXIS_KEYS and ndim >= 2:
            # [*, in, out]: reduce the input axis only → one scale per
            # (leading..., output channel), rank preserved
            reduce_axis, row_scaled = -2, False
        elif name in _ROW_AXIS_KEYS and ndim == 2:
            reduce_axis, row_scaled = -1, True  # per vocab row
        else:
            out[name] = value  # untouched
            continue
        v = torch.as_tensor(value)
        s = v.abs().amax(dim=reduce_axis, keepdim=True)
        s = torch.clamp_min(s, 1e-12) / 127.0
        q = torch.div(v, s).round_().clamp_(-127, 127).to(torch.int8)
        out[name] = QuantizedTensor(q, s.to(torch.float32), row_scaled)
    return out


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Materialize every :class:`QuantizedTensor` back to float32."""
    return {
        k: (v.dequantize() if isinstance(v, QuantizedTensor) else v)
        for k, v in params.items()
    }


def quantized_nbytes(params: Dict[str, Any]) -> int:
    return sum(int(v.nbytes) for v in params.values())
