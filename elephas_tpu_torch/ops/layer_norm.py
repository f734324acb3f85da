"""Fused LayerNorm forward (port of ``elephas_tpu/ops/layer_norm.py``).

:func:`layer_norm` is the dispatcher the model calls: on a CUDA tensor it
launches the hand-written kernel in ``csrc/layer_norm.cu`` (one block per
row, one read of the row, centred variance); on a CPU tensor it runs
:func:`layer_norm_reference`, the plain PyTorch version that is also the
kernel's oracle. The output is float32 either way, as the reference's
dispatcher guarantees. The backward kernel is not ported yet: this slice
serves, it does not train.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the whole row sits in shared memory: 227 KB a block on Hopper
_MAX_D = 227 * 1024 // 4

_SIGNATURES = {
    "layer_norm_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_void_p],
}


def layer_norm_reference(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of ``[..., D]`` with affine params [D]."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """The CUDA kernel: ``x`` ``[..., D]`` on a CUDA device, ``scale`` and
    ``bias`` ``[D]`` on the same device. Returns float32 in ``x``'s shape.
    Raises on anything the kernel does not take; counts each launch in
    ``fused_layer_norm.launches``."""
    if not x.is_cuda:
        raise ValueError("fused_layer_norm needs a CUDA tensor")
    D = x.shape[-1]
    if tuple(scale.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError(f"scale/bias must be [{D}], got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must be on one device")
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"feature dim {D} not in [1, {_MAX_D}]")
    x2 = x.reshape(-1, D).to(torch.float32).contiguous()
    s = scale.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x2)
    lib = _build.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.layer_norm_fwd(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
            x2.shape[0], D, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layer_norm_fwd")
    fused_layer_norm.launches += 1
    return out.reshape(x.shape)


fused_layer_norm.launches = 0


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Dispatcher: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor. Always float32."""
    if x.is_cuda:
        return fused_layer_norm(x, scale, bias, eps)
    return layer_norm_reference(x, scale, bias, eps).to(torch.float32)
