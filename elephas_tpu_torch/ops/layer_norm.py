"""Fused LayerNorm, forward and backward (port of ``elephas_tpu/ops/layer_norm.py``).

:func:`layer_norm` is the dispatcher the model calls: on a CUDA tensor it
runs a ``torch.autograd.Function`` over the hand-written kernels in
``csrc/layer_norm.cu`` (:func:`fused_layer_norm`, K3-fwd: one read of the
row, centred variance; one warp a row with the row in registers up to
``D`` 1024, one block a row above; :func:`fused_layer_norm_bwd`,
K3-bwd: ``dx`` plus per-block partials of ``dscale``/``dbias`` summed in a
second, deterministic pass; one warp a row with the row in registers up
to ``D`` 1024, one block a row above). Like the reference's VJP it saves
only ``x`` and ``scale`` and recomputes ``x̂`` in the backward. On a CPU tensor it
runs :func:`layer_norm_reference`, the plain PyTorch version that autograd
differentiates and that is also the kernels' oracle. The output is float32
either way, as the reference's dispatcher guarantees.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the forward's wide route keeps the row in shared memory (227 KB a block
# on Hopper); the backward's keeps the x and g rows and two partial rows
_MAX_D = 227 * 1024 // 4
_MAX_D_BWD = 227 * 1024 // 16
# both rows routes (one warp a row, the row in registers) take rows up to
# this width (kRowMaxD in the .cu); wider rows take the wide route (one
# block a row)
_ROW_MAX_D = 1024
# the backward's pass 1 runs at most this many blocks (two of 4 warps an
# SM on an H100's 132), each over a contiguous run of rows; the count
# depends on N alone, so the order of the dscale/dbias sums does too
_BWD_BLOCKS = 264

_SIGNATURES = {
    "layer_norm_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
    "layer_norm_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
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


def _route(D: int, *tensors):
    """``(route, vec)`` of a kernel call: route 0 (one warp a row) up to
    ``_ROW_MAX_D`` columns, else 1 (one block a row); ``vec`` when rows of
    ``D`` floats are read and written as float4, i.e. ``D % 4 == 0`` and
    every tensor starts 16-byte aligned."""
    return (0 if D <= _ROW_MAX_D else 1,
            int(D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)))


def fused_layer_norm(x, scale, bias, eps: float = 1e-5, interpret: bool = False):
    """K3-fwd, the CUDA kernel: ``x`` ``[..., D]`` on a CUDA device,
    ``scale`` and ``bias`` ``[D]`` on the same device. Returns float32 in
    ``x``'s shape. Raises on anything the kernel does not take; counts each
    launch in ``fused_layer_norm.launches``. ``interpret`` steers only the
    reference's Pallas kernel; it is accepted in its place and ignored."""
    D = _check(x, scale, (bias,), _MAX_D, "fused_layer_norm")
    x2 = x.reshape(-1, D).to(torch.float32).contiguous()
    s = scale.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x2)
    route, vec = _route(D, x2, s, b, out)
    lib = _build.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.layer_norm_fwd(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
            x2.shape[0], D, route, vec, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layer_norm_fwd")
    _build.count_launch(fused_layer_norm)
    return out.reshape(x.shape)


fused_layer_norm.launches = 0


def _bwd_grid(N: int):
    """K3-bwd's pass-1 grid for ``N`` rows: ``(n_blocks, rows)``, at most
    ``_BWD_BLOCKS`` blocks of ``rows`` contiguous rows, none empty. It
    depends on ``N`` alone, not on ``D``, the route or the card, so the
    order of every dscale/dbias sum, and with it their bits, does too."""
    rows = -(-N // _BWD_BLOCKS) if N else 1
    return -(-N // rows), rows


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
    n_blocks, rows = _bwd_grid(N)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x2)
    route, vec = _route(D, x2, g2, s, dx)
    ds_part = torch.empty((n_blocks, D), **f32)
    db_part = torch.empty((n_blocks, D), **f32)
    dscale = torch.empty((D,), **f32)
    dbias = torch.empty((D,), **f32)
    lib = _build.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.layer_norm_bwd(
            x2.data_ptr(), s.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            ds_part.data_ptr(), db_part.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), N, D, n_blocks, rows, route, vec, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "layer_norm_bwd")
    _build.count_launch(fused_layer_norm_bwd)
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
