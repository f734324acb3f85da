"""Grouped matrix products for mixture-of-experts FFNs (port of
``elephas_tpu/ops/grouped_matmul.py``).

Rows are laid out sorted by expert in ``tm``-row tiles, each tile owned by
one expert (``parallel/expert.py`` builds the layout): ``lhs`` ``[M, K]``
with ``M = len(gmap) * tm`` and ``gmap`` the int32, non-decreasing tile →
expert map.

- :func:`gmm`: ``out[r] = lhs[r] @ rhs[gmap[r // tm]]`` for ``rhs`` ``[E, K,
  N]``, differentiable: its backward is :func:`gmm_t` for ``dlhs`` and
  :func:`tgmm` for ``drhs``, as the reference's custom VJP.
- :func:`gmm_t`: the same with ``rhs`` ``[E, N, K]`` read transposed (the
  ``dL/dx`` product); its backward is :func:`gmm` and :func:`tgmm`.
- :func:`tgmm`: ``out[e] = Σ_{t: gmap[t]=e} lhs_tᵀ @ g_t`` → ``[E, K, N]``,
  an expert with no tile coming out zero. Not differentiated: it is the
  backward.

Each dispatches by the tensors' device: on the CPU the plain versions
(:func:`gmm_reference`, :func:`tgmm_reference`, also the kernels' oracle),
on a CUDA device the hand-written kernels in ``csrc/grouped_matmul.cu``
(K6-gmm and K6-tgmm on the tensor cores: 3xTF32 ``mma.sync`` for float32,
bf16 ``mma.sync`` for bf16), or a raise. The output is in ``lhs``'s
dtype (``tgmm``: ``out_dtype``), every sum float32, inputs float32 or
bfloat16. The plain
versions loop over the runs of equal experts in ``gmap`` rather than
gathering ``rhs[gmap]`` (a ``[M/tm, K, N]`` copy of the weights), so they
stay usable as the oracle at full model width.

The reference gates its kernel by shape (``tileable``) and backend and
splits deep contractions into several calls (a VMEM workaround); here one
launch takes any ``K`` and ``N`` and loops over all of ``K``, and the only
shape rule is that ``tm`` be a multiple of the kernel's 128-row tile.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import _build

_ROW_TILE = 128          # kBM in the .cu: tm must be a multiple
_COL_TILE = 128          # kBN
_MAX_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1

_SIGNATURES = {
    "gmm": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "tgmm": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}
_DTYPES = (torch.float32, torch.bfloat16)


# -- plain versions (CPU path and oracle) --------------------------------------


def _runs(gmap) -> List[Tuple[int, int, int]]:
    """``(expert, first tile, end tile)`` of each run of equal entries of
    ``gmap`` (one host read of the map)."""
    g = gmap.tolist()
    runs, start = [], 0
    for t in range(1, len(g) + 1):
        if t == len(g) or g[t] != g[start]:
            runs.append((int(g[start]), start, t))
            start = t
    return runs


def _tile_rows(lhs, gmap) -> int:
    nm = gmap.numel()
    if gmap.dim() != 1 or nm == 0 or lhs.shape[0] % nm:
        raise ValueError(f"{lhs.shape[0]} rows do not split into "
                         f"{tuple(gmap.shape)} tiles")
    return lhs.shape[0] // nm


def gmm_reference(lhs, rhs, gmap, transpose_rhs: bool = False):
    """``out[r] = lhs[r] @ rhs[gmap[r // tm]]`` (``rhs[...]ᵀ`` under
    ``transpose_rhs``) in plain PyTorch, one float32 product per run of
    equal experts, cast to ``lhs``'s dtype."""
    tm = _tile_rows(lhs, gmap)
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.empty((lhs.shape[0], n), dtype=lhs.dtype, device=lhs.device)
    f32 = torch.float32
    for e, t0, t1 in _runs(gmap):
        w = rhs[e].T if transpose_rhs else rhs[e]
        rows = slice(t0 * tm, t1 * tm)
        out[rows] = (lhs[rows].to(f32) @ w.to(f32)).to(lhs.dtype)
    return out


def tgmm_reference(lhs, g, gmap, n_groups: int):
    """``out[e] = Σ_{t: gmap[t]=e} lhs_tᵀ @ g_t`` in plain PyTorch →
    ``[n_groups, K, N]`` float32, zero for a group with no tile."""
    tm = _tile_rows(lhs, gmap)
    f32 = torch.float32
    out = torch.zeros((n_groups, lhs.shape[1], g.shape[1]), dtype=f32,
                      device=lhs.device)
    for e, t0, t1 in _runs(gmap):
        rows = slice(t0 * tm, t1 * tm)
        out[e] += lhs[rows].to(f32).T @ g[rows].to(f32)
    return out


# -- the CUDA kernels --------------------------------------------------------------


def _check(what: str, a, b, gmap):
    """Shared argument checks of the kernels: ``(tm, gmap as contiguous
    int32)``."""
    if not (a.is_cuda and b.device == a.device and gmap.device == a.device):
        raise ValueError(f"{what} needs its operands and gmap on one CUDA device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"{what}: operands must both be float32 or both "
                         f"bfloat16, got {a.dtype} and {b.dtype}")
    if gmap.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: gmap must be an integer tensor, got {gmap.dtype}")
    tm = _tile_rows(a, gmap)
    if tm % _ROW_TILE:
        raise ValueError(f"{what}: tile of {tm} rows is not a multiple of the "
                         f"kernel's {_ROW_TILE}-row block")
    if max(*a.shape, *b.shape) > _INT_MAX:
        raise ValueError(f"{what}: a dimension exceeds the kernel's int indices")
    return tm, gmap.to(torch.int32).contiguous()


def _launch_gmm(lhs, rhs, gmap, transpose: bool):
    """K6-gmm (``transpose=False``) or its transposed-weights twin: one
    launch, counted in ``gmm.launches`` or ``gmm_t.launches``."""
    name = "gmm_t" if transpose else "gmm"
    tm, gmap32 = _check(name, lhs, rhs, gmap)
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"{name}: lhs must be [M, K] and rhs [E, ., .], got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    M, K = lhs.shape
    E = rhs.shape[0]
    N, k_w = (rhs.shape[1], rhs.shape[2]) if transpose else (rhs.shape[2], rhs.shape[1])
    if k_w != K:
        raise ValueError(f"{name}: contraction {K} of lhs vs {k_w} of rhs "
                         f"{tuple(rhs.shape)}")
    if -(-N // _COL_TILE) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: {N} output columns exceed the grid")
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    # every row of lhs and rhs starts on a 16-byte boundary: the copies into
    # the kernel's ring take 16 bytes at a time, else element by element
    per16 = 16 // lhs.element_size()
    vec = int(K % per16 == 0 and N % per16 == 0
              and lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0)
    lib = _build.load("grouped_matmul", _SIGNATURES)
    with torch.cuda.device(lhs.device):
        err = lib.gmm(lhs.data_ptr(), rhs.data_ptr(), gmap32.data_ptr(),
                      out.data_ptr(), M, K, N, E, tm, int(transpose),
                      int(lhs.dtype == torch.bfloat16), vec,
                      torch.cuda.current_stream(lhs.device).cuda_stream)
    _build.check(lib, err, name)
    _build.count_launch(gmm_t if transpose else gmm)
    return out


def _launch_tgmm(lhs, g, gmap, n_groups: int, out_dtype):
    tm, gmap32 = _check("tgmm", lhs, g, gmap)
    if lhs.dim() != 2 or g.dim() != 2 or g.shape[0] != lhs.shape[0]:
        raise ValueError(f"tgmm: lhs [M, K] and g [M, N] expected, got "
                         f"{tuple(lhs.shape)} and {tuple(g.shape)}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"tgmm: out_dtype must be float32 or bfloat16, got {out_dtype}")
    K, N = lhs.shape[1], g.shape[1]
    if not 0 <= n_groups <= _MAX_GRID_YZ or -(-N // _COL_TILE) > _MAX_GRID_YZ:
        raise ValueError(f"tgmm: {n_groups} groups x {N} columns exceed the grid")
    lhs, g = lhs.contiguous(), g.contiguous()
    out = torch.empty((n_groups, K, N), dtype=out_dtype, device=lhs.device)
    lib = _build.load("grouped_matmul", _SIGNATURES)
    with torch.cuda.device(lhs.device):
        err = lib.tgmm(lhs.data_ptr(), g.data_ptr(), gmap32.data_ptr(),
                       out.data_ptr(), K, N, gmap32.numel(), tm, n_groups,
                       int(lhs.dtype == torch.bfloat16),
                       int(out_dtype == torch.bfloat16),
                       torch.cuda.current_stream(lhs.device).cuda_stream)
    _build.check(lib, err, "tgmm")
    _build.count_launch(tgmm)
    return out


# -- dispatchers ---------------------------------------------------------------------


def _product(lhs, rhs, gmap, transpose: bool):
    """Forward-only grouped product: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if lhs.is_cuda:
        return _launch_gmm(lhs, rhs, gmap, transpose)
    return gmm_reference(lhs, rhs, gmap, transpose)


class _Gmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, gmap):
        ctx.save_for_backward(lhs, rhs, gmap)
        return _product(lhs, rhs, gmap, False)

    @staticmethod
    def backward(ctx, gy):
        lhs, rhs, gmap = ctx.saved_tensors
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _product(gy, rhs, gmap, True)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, gy, gmap, rhs.shape[0], rhs.dtype)
        return dlhs, drhs, None


class _GmmT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, gmap):
        ctx.save_for_backward(lhs, rhs, gmap)
        return _product(lhs, rhs, gmap, True)

    @staticmethod
    def backward(ctx, gy):
        lhs, rhs, gmap = ctx.saved_tensors
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _product(gy, rhs, gmap, False)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(gy, lhs, gmap, rhs.shape[0], rhs.dtype)
        return dlhs, drhs, None


def gmm(lhs, rhs, gmap, interpret: bool = False):
    """Grouped matmul ``out[r] = lhs[r] @ rhs[gmap[r // tm]]``: ``lhs`` ``[M,
    K]``, ``rhs`` ``[E, K, N]``, ``gmap`` ``[M // tm]`` integer,
    non-decreasing → ``[M, N]`` in ``lhs``'s dtype (float32 sums).
    Differentiable in ``lhs`` and ``rhs``. ``gmm.launches`` counts the
    K6-gmm kernel's launches. ``interpret`` steers only the reference's
    Pallas kernel; it is accepted in its place and ignored."""
    return _Gmm.apply(lhs, rhs, gmap)


def gmm_t(lhs, rhs, gmap, interpret: bool = False):
    """:func:`gmm` with transposed group weights, ``out[r] = lhs[r] @
    rhs[gmap[r // tm]]ᵀ`` for ``rhs`` ``[E, N, K]`` (the weights stay in
    their forward layout and are read transposed). ``gmm_t.launches``
    counts its kernel's launches. ``interpret`` as in :func:`gmm`."""
    return _GmmT.apply(lhs, rhs, gmap)


def tgmm(lhs, g, gmap, n_groups: int, out_dtype=torch.float32,
         interpret: bool = False):
    """Per-group weight gradient ``out[e] = Σ_{t: gmap[t]=e} lhs_tᵀ @ g_t``
    over ``tm``-row tiles: ``lhs`` ``[M, K]``, ``g`` ``[M, N]`` → ``[n_groups,
    K, N]`` in ``out_dtype``, float32 sums, zero for a group with no tile.
    ``gmap`` must be non-decreasing. ``tgmm.launches`` counts K6-tgmm's
    launches. ``interpret`` as in :func:`gmm`."""
    if lhs.is_cuda:
        return _launch_tgmm(lhs, g, gmap, n_groups, out_dtype)
    return tgmm_reference(lhs, g, gmap, n_groups).to(out_dtype)


gmm.launches = 0
gmm_t.launches = 0
tgmm.launches = 0
