"""Fused per-sample categorical cross-entropy from logits, forward and
backward (port of ``elephas_tpu/ops/pallas_ops.py``).

K1-fwd (:func:`fused_xent_fwd`) and K1-bwd (:func:`fused_xent_bwd`) are
the hand-written kernels in ``csrc/fused_xent.cu``: per row, the forward
computes ``sum_j y_j * (lse(x) - x_j)`` and the backward ``(softmax(x) -
y) * g``, the softmax recomputed from the logits, each in one launch over
all rows. Beside them stand their plain versions
(:func:`fused_xent_fwd_reference`, :func:`fused_xent_bwd_reference`), the
CPU path and the kernels' oracle, and the reference's own jnp function
:func:`xent_from_logits_reference`, ``lse(x) - <y, x>``.

The kernels keep the TPU kernels' arithmetic, so their forward and the
oracle agree only on rows whose labels sum to 1 (one-hot or soft
distributions): a row of zero labels gives 0 here and ``lse(x)`` there.
The backward is the oracle's gradient on every row. The fit's padded
samples have zero labels and zero weight, so no fit sees the difference.

Logits ``[B, C]`` are float32 or bf16 and every operation runs in float32;
labels ``[B, C]``; the loss is float32 ``[B]`` and the logits' gradient
comes back in the logits' dtype. Nothing is padded: the TPU padded B to 8
rows and C to 128 lanes with -1e30 logits, the CUDA kernels mask the
ragged edge by index.

:func:`categorical_crossentropy_from_logits` is the dispatcher the losses
call: the kernels for a CUDA tensor, the plain versions for a CPU tensor,
each pair under a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SIGNATURES = {
    "fused_xent_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "fused_xent_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def xent_from_logits_reference(logits, labels):
    """Per-sample CE from logits, one-hot labels: ``lse(x) - <y, x>``."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - (labels * logits).sum(dim=-1)


def _row_softmax_parts(logits):
    """``(x, m, e)``: float32 logits, their row max and ``exp(x - m)``."""
    x = logits.to(torch.float32)
    m = x.amax(dim=-1, keepdim=True)
    return x, m, torch.exp(x - m)


def fused_xent_fwd_reference(logits, labels):
    """The plain version of K1-fwd: ``sum(y * (lse - x))`` per row, float32
    ``[B]``, with the row max taken before the exponent."""
    x, m, e = _row_softmax_parts(logits)
    lse = torch.log(e.sum(dim=-1, keepdim=True)) + m
    return (labels.to(torch.float32) * (lse - x)).sum(dim=-1)


def fused_xent_bwd_reference(logits, labels, g):
    """The plain version of K1-bwd: ``(softmax(x) - y) * g`` in the logits'
    dtype."""
    _, _, e = _row_softmax_parts(logits)
    p = e / e.sum(dim=-1, keepdim=True)
    dx = (p - labels.to(torch.float32)) * g.to(torch.float32)[:, None]
    return dx.to(logits.dtype)


def _check(logits, labels, what: str):
    if not logits.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if logits.dim() != 2 or labels.shape != logits.shape:
        raise ValueError(f"{what}: logits and labels must both be [B, C], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"{what}: logits and labels must be on one device")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: logits must be float32 or bfloat16, got "
                         f"{logits.dtype}")
    B, C = logits.shape
    if C < 1:
        raise ValueError(f"{what}: no classes")
    if max(B, C) >= 2 ** 31:
        raise ValueError(f"{what}: [{B}, {C}] does not fit the kernel's int sizes")
    return (logits.contiguous(), labels.to(torch.float32).contiguous(), B, C,
            int(logits.dtype == torch.bfloat16))


def fused_xent_fwd(logits, labels):
    """K1-fwd, the CUDA kernel: ``logits`` ``[B, C]`` (float32 or bf16) and
    ``labels`` ``[B, C]`` on one CUDA device; returns the float32 ``[B]``
    per-row ``sum(y * (lse - x))``. Raises on anything the kernel does not
    take; counts each launch in ``fused_xent_fwd.launches``."""
    x, y, B, C, bf16 = _check(logits, labels, "fused_xent_fwd")
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _build.load("fused_xent", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.fused_xent_fwd(x.data_ptr(), y.data_ptr(), out.data_ptr(), B, C,
                                 bf16, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fused_xent_fwd")
    fused_xent_fwd.launches += 1
    return out


fused_xent_fwd.launches = 0


def fused_xent_bwd(logits, labels, g):
    """K1-bwd, the CUDA kernel: ``(softmax(x) - y) * g`` for the cotangent
    ``g`` ``[B]``, in the logits' dtype. Counts each launch in
    ``fused_xent_bwd.launches``."""
    x, y, B, C, bf16 = _check(logits, labels, "fused_xent_bwd")
    if g.shape != (B,) or g.device != x.device:
        raise ValueError(f"fused_xent_bwd: cotangent {tuple(g.shape)} on "
                         f"{g.device} does not match [{B}] on {x.device}")
    g = g.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    if B == 0:
        return dx
    lib = _build.load("fused_xent", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.fused_xent_bwd(x.data_ptr(), y.data_ptr(), g.data_ptr(),
                                 dx.data_ptr(), B, C, bf16,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fused_xent_bwd")
    fused_xent_bwd.launches += 1
    return dx


fused_xent_bwd.launches = 0


def _xent_function(fwd, bwd, name: str):
    """A ``torch.autograd.Function`` with ``fwd`` as its forward and ``bwd``
    as its backward; saves the logits and labels, as the reference's VJP
    does, and gives the labels no gradient."""

    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return fwd(logits, labels)

    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return bwd(logits, labels, g), None

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(forward), "backward": staticmethod(backward)})


_FusedXent = _xent_function(fused_xent_fwd, fused_xent_bwd, "_FusedXent")
_PlainXent = _xent_function(fused_xent_fwd_reference, fused_xent_bwd_reference,
                            "_PlainXent")


def fused_xent_from_logits(logits, labels, interpret=False):
    """Fused per-sample categorical cross-entropy from logits: K1-fwd, with
    K1-bwd as its gradient. CUDA tensors only. ``interpret`` steers only the
    reference's Pallas kernel; it is accepted in its place and ignored."""
    return _FusedXent.apply(logits, labels)


def categorical_crossentropy_from_logits(logits, labels):
    """Dispatcher: the kernels for a CUDA tensor, their plain versions for a
    CPU tensor (the same forward and backward); no fallback between them."""
    if logits.is_cuda:
        return _FusedXent.apply(logits, labels)
    return _PlainXent.apply(logits, labels)
