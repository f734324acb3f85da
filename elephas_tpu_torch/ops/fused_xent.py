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

Logits ``[B, C]`` are float32, bf16 or fp16 and every operation runs in
float32 (a 16-bit logit widens exactly);
labels ``[B, C]``; the loss is float32 ``[B]`` and the logits' gradient
comes back in the logits' dtype. Nothing is padded: the TPU padded B to 8
rows and C to 128 lanes with -1e30 logits, the CUDA kernels mask the
ragged edge by index.

Each kernel reads every input byte once, on one of three routes that
:func:`xent_plan` picks from ``C``, the logits' dtype and the pointers'
alignment (the C entry points validate the choice): ``warp`` (C <= 1024,
the MLP fit's rows among them: one warp a row, the row in registers),
``cluster`` (a row held in the shared memory of a cluster of up to eight
CTAs, each CTA's max and sum exchanged through distributed shared memory
and merged in rank order) and ``stream`` (rows past the cluster's
capacity: the same kernel over a cluster of eight, its passes reading
device memory). The plan's constants are read from the kernel's source,
and :func:`launch_shape` asks the built library what launch a plan makes.

:func:`categorical_crossentropy_from_logits` is the dispatcher the losses
call: the kernels for a CUDA tensor, the plain versions for a CPU tensor,
each pair under a ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import torch

from . import _build

_SIGNATURES = {
    "fused_xent_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "fused_xent_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "fused_xent_launch_shape": [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)],
}


def _source_constants(path: Path) -> dict:
    """The ``constexpr int kName = <digits>;`` lines of a kernel source."""
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                             path.read_text())}


# the routes of csrc/fused_xent.cu (its `enum Route`), and the constants
# the plan needs, read from that source: one warp a row up to kWarpMax
# classes; a cluster of at most kMaxCluster CTAs, each slice a multiple of
# kSliceUnit elements in at most kSmemBudget bytes of shared memory
ROUTES = ("warp", "cluster", "stream")
# the logits' types the kernels take, in the order of the .cu's `enum XType`
X_TYPES = (torch.float32, torch.bfloat16, torch.float16)
_CU = _source_constants(_build.CSRC / "fused_xent.cu")
_WARP_MAX, _CLUSTER_MAX, _SLICE_UNIT, _SMEM_BUDGET = (
    _CU[k] for k in ("kWarpMax", "kMaxCluster", "kSliceUnit", "kSmemBudget"))
# a cluster CTA aims at this many elements of a row (64-100 KB of x and y
# in float32): on the H100 a CTA's fixed costs (its barriers, the bulk
# copies' latency, the exchange) outweigh more CTAs in flight, so one CTA
# a row was fastest up to C 8192 and four beat eight at C 50257
_CLUSTER_TARGET = 12800


def _cluster_smem(slice_: int, itemsize: int) -> int:
    """Dynamic shared memory of a cluster CTA: its slice of x and of the
    float32 labels, each from the 16-byte boundary at or below the slice's
    first element (``slice_bytes`` in the .cu; the card tests hold the two
    to each other through :func:`launch_shape`)."""
    def part(elem):
        return -(-((slice_ + 16 // elem) * elem) // 16) * 16
    return part(itemsize) + part(4)


def xent_plan(C: int, itemsize: int, vec_max: int = 4):
    """``(route, vec, cluster, slice)`` of a K1 launch over rows of ``C``
    classes with ``itemsize``-byte logits (4 float32, 2 bf16 or fp16) whose x, y
    and dx pointers all allow vector loads of ``vec_max`` elements (4, 2 or
    1, :func:`_vec_max`): ``route`` indexes :data:`ROUTES`; ``vec`` is the
    elements a load on the warp route (4 or 1; 1 on the others);
    ``cluster`` the CTAs a row and ``slice`` the elements each takes on the
    cluster and stream routes. A pure function: every ``C >= 1`` gets a
    route."""
    if C < 1:
        raise ValueError(f"xent_plan: C must be >= 1, got {C}")
    if C <= _WARP_MAX:
        return ROUTES.index("warp"), 4 if C % 4 == 0 and vec_max == 4 else 1, 1, 0
    n = min(_CLUSTER_MAX, -(-C // _CLUSTER_TARGET))
    if _cluster_smem(_slice(C, n), itemsize) <= _SMEM_BUDGET:
        return ROUTES.index("cluster"), 1, n, _slice(C, n)
    return ROUTES.index("stream"), 1, _CLUSTER_MAX, _slice(C, _CLUSTER_MAX)


def _slice(C: int, n: int) -> int:
    """Elements of a row each of ``n`` CTAs takes: a whole number of
    units, the last CTA the rest."""
    return -(-(-(-C // n)) // _SLICE_UNIT) * _SLICE_UNIT


def cluster_capacity(itemsize: int) -> int:
    """The widest row the cluster route holds: eight CTAs, each slice (a
    whole number of units) within the shared-memory budget."""
    slice_ = _SMEM_BUDGET // (itemsize + 4) // _SLICE_UNIT * _SLICE_UNIT
    while _cluster_smem(slice_, itemsize) > _SMEM_BUDGET:
        slice_ -= _SLICE_UNIT
    return _CLUSTER_MAX * slice_


def launch_shape(B: int, C: int, dtype, plan):
    """``(blocks, threads a block, dynamic shared memory bytes)`` of the
    launch that ``plan`` makes over ``[B, C]`` logits of ``dtype``, as the
    built library (``fused_xent_launch_shape``) sizes it; raises on a plan
    the C entry points refuse."""
    lib = _build.load("fused_xent", _SIGNATURES)
    shape = (ctypes.c_int * 3)()
    err = lib.fused_xent_launch_shape(B, C, X_TYPES.index(dtype), *plan, shape)
    _build.check(lib, err, "fused_xent_launch_shape")
    return tuple(shape)


def _vec_max(*tensors) -> int:
    """The most elements (4, 2 or 1) a vector load or store may take at
    every tensor's data pointer: 4 v-byte alignment for float32, 2 v for
    bf16 and fp16."""
    v = 4
    while any(t.data_ptr() % (v * t.element_size()) for t in tensors):
        v //= 2
    return v


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
    if logits.dtype not in X_TYPES:
        raise ValueError(f"{what}: logits must be float32, bfloat16 or float16, got "
                         f"{logits.dtype}")
    B, C = logits.shape
    if C < 1:
        raise ValueError(f"{what}: no classes")
    if max(B, C) >= 2 ** 31:
        raise ValueError(f"{what}: [{B}, {C}] does not fit the kernel's int sizes")
    return logits.contiguous(), labels.to(torch.float32).contiguous(), B, C


def _launch(entry, x, y, g, out, plan=None):
    """One launch of the C entry ``entry`` (``fused_xent_fwd`` or
    ``fused_xent_bwd``, ``g`` None for the former) on contiguous checked
    tensors, with ``plan`` (:func:`xent_plan`'s by default); raises on the
    error it returns, else counts the launch on the wrapper of that name."""
    B, C = x.shape
    ptrs = [x, y] + ([g] if g is not None else []) + [out]
    if plan is None:   # the rows' vector loads and stores: x, y and dx
        plan = xent_plan(C, x.element_size(),
                         _vec_max(x, y, *([out] if g is not None else [])))
    lib = _build.load("fused_xent", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(*(t.data_ptr() for t in ptrs), B, C,
                                  X_TYPES.index(x.dtype), *plan,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, entry)
    _build.count_launch(_WRAPPERS[entry])


def fused_xent_fwd(logits, labels):
    """K1-fwd, the CUDA kernel: ``logits`` ``[B, C]`` (float32, bf16 or fp16) and
    ``labels`` ``[B, C]`` on one CUDA device; returns the float32 ``[B]``
    per-row ``sum(y * (lse - x))``. Raises on anything the kernel does not
    take; counts each launch in ``fused_xent_fwd.launches``."""
    x, y, B, C = _check(logits, labels, "fused_xent_fwd")
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B:
        _launch("fused_xent_fwd", x, y, None, out)
    return out


fused_xent_fwd.launches = 0


def fused_xent_bwd(logits, labels, g):
    """K1-bwd, the CUDA kernel: ``(softmax(x) - y) * g`` for the cotangent
    ``g`` ``[B]``, in the logits' dtype. Counts each launch in
    ``fused_xent_bwd.launches``."""
    x, y, B, C = _check(logits, labels, "fused_xent_bwd")
    if g.shape != (B,) or g.device != x.device:
        raise ValueError(f"fused_xent_bwd: cotangent {tuple(g.shape)} on "
                         f"{g.device} does not match [{B}] on {x.device}")
    g = g.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    if B:
        _launch("fused_xent_bwd", x, y, g, dx)
    return dx


fused_xent_bwd.launches = 0
_WRAPPERS = {"fused_xent_fwd": fused_xent_fwd, "fused_xent_bwd": fused_xent_bwd}


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
