"""Fused LayerNorm, forward and backward (port of ``elephas_tpu/ops/layer_norm.py``).

:func:`layer_norm` is the dispatcher the model calls: on a CUDA tensor it
runs a ``torch.autograd.Function`` over the hand-written kernels in
``csrc/layer_norm.cu`` (:func:`fused_layer_norm`, K3-fwd: one block per
row, one read of the row, centred variance; :func:`fused_layer_norm_bwd`,
K3-bwd: ``dx`` plus per-block partials of ``dscale``/``dbias`` summed in a
second, deterministic pass). Like the reference's VJP it saves only ``x``
and ``scale`` and recomputes ``x̂`` in the backward. On a CPU tensor it
runs :func:`layer_norm_reference`, the plain PyTorch version that autograd
differentiates and that is also the kernels' oracle. The output is float32
either way, as the reference's dispatcher guarantees.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the forward keeps the row in shared memory (227 KB a block on Hopper);
# the backward keeps the x and g rows and two partial rows
_MAX_D = 227 * 1024 // 4
_MAX_D_BWD = 227 * 1024 // 16
# the backward's pass 1 runs at most this many blocks, each over a
# contiguous run of rows; the count depends on N alone, so the order of
# the dscale/dbias sums does too
_BWD_BLOCKS = 512

_SIGNATURES = {
    "layer_norm_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_void_p],
    "layer_norm_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
}


def layer_norm_reference(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of ``[..., D]`` with affine params [D]."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _check(x, scale, others, max_d: int, what: str):
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    D = x.shape[-1]
    if tuple(scale.shape) != (D,) or any(tuple(o.shape) != (D,) for o in others):
        raise ValueError(f"scale/bias must be [{D}], got {tuple(scale.shape)} "
                         f"and {[tuple(o.shape) for o in others]}")
    if any(t.device != x.device for t in (scale, *others)):
        raise ValueError("x, scale and bias must be on one device")
    if not 1 <= D <= max_d:
        raise ValueError(f"feature dim {D} not in [1, {max_d}]")
    return D


def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """K3-fwd, the CUDA kernel: ``x`` ``[..., D]`` on a CUDA device,
    ``scale`` and ``bias`` ``[D]`` on the same device. Returns float32 in
    ``x``'s shape. Raises on anything the kernel does not take; counts each
    launch in ``fused_layer_norm.launches``."""
    D = _check(x, scale, (bias,), _MAX_D, "fused_layer_norm")
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


def fused_layer_norm_bwd(x, scale, g, eps: float = 1e-5):
    """K3-bwd, the CUDA kernel: the gradients of :func:`fused_layer_norm`
    for the output cotangent ``g`` (``x``'s shape), as float32 ``(dx,
    dscale, dbias)``. ``dscale``/``dbias`` are summed without atomics, in
    an order fixed by the row count. Counts each launch in
    ``fused_layer_norm_bwd.launches``."""
    D = _check(x, scale, (), _MAX_D_BWD, "fused_layer_norm_bwd")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"cotangent {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)}")
    x2 = x.reshape(-1, D).to(torch.float32).contiguous()
    g2 = g.reshape(-1, D).to(torch.float32).contiguous()
    s = scale.to(torch.float32).contiguous()
    N = x2.shape[0]
    rows = -(-N // _BWD_BLOCKS) if N else 1
    n_blocks = -(-N // rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x2)
    ds_part = torch.empty((n_blocks, D), **f32)
    db_part = torch.empty((n_blocks, D), **f32)
    dscale = torch.empty((D,), **f32)
    dbias = torch.empty((D,), **f32)
    lib = _build.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.layer_norm_bwd(
            x2.data_ptr(), s.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            ds_part.data_ptr(), db_part.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), N, D, n_blocks, rows, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layer_norm_bwd")
    fused_layer_norm_bwd.launches += 1
    return dx.reshape(x.shape), dscale, dbias


fused_layer_norm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """K3-fwd with K3-bwd as its backward; saves ``x`` and ``scale`` only."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return fused_layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = fused_layer_norm_bwd(x, scale, g, ctx.eps)
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Dispatcher: the CUDA kernels for a CUDA tensor (through the autograd
    Function only when a gradient is wanted: a decode step calls this 2L+1
    times and needs no graph), the plain version for a CPU tensor. Always
    float32."""
    if not x.is_cuda:
        return layer_norm_reference(x, scale, bias, eps).to(torch.float32)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _FusedLayerNorm.apply(x, scale, bias, float(eps))
    return fused_layer_norm(x, scale, bias, eps)
