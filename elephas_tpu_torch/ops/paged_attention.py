"""Paged attention: decode straight over a KV page pool through a block
table (port of ``elephas_tpu/ops/paged_attention.py``).

Layouts follow the reference: one layer's pool ``kp``/``vp`` ``[P, Hkv,
page, Dh]``, the block table ``[S, M]`` int32 (row ``s`` maps slot ``s``'s
logical page ``m`` to a pool page; unmapped cells hold 0, the trash page,
whose finite garbage is masked by position). Two kernel families:

* single-token decode — :func:`paged_flash_decode_lse`: one query per slot
  at ``pos[s]``, online softmax over the slot's page chain, plus the lse;
* multi-row chunk — :func:`paged_flash_chunk`: ``C`` queries per slot at
  ``pos0[s] .. pos0[s] + C - 1``, each with its own causal bound (chunked
  prefill, prefix-adopted suffixes).

On CUDA tensors the dispatchers launch the kernels in
``csrc/paged_attention.cu``; on CPU tensors they run the plain versions,
which gather a transient per-slot view (:func:`paged_view_rows`) and then
call the very functions the dense CPU path calls
(``decode_attention_reference_lse`` and ``chunk_attention_reference``).
With the view's time axis equal to the dense capacity, paged and dense are
therefore bitwise equal on the CPU, the reference's own contract. On the
card the kernels accumulate in another order than the dense ones, so there
the two agree to float32 rounding, not bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
# the split rule of K5-decode is the dense K4's (csrc/decode_split.cuh)
from .flash_decode import (_ALIGN, _SMEM_LIMIT, _decode_smem, _splits,
                           chunk_attention_reference, decode_attention_reference_lse,
                           decode_pieces)

_MAX_DH = 256

_SIGNATURES = {
    "paged_decode_lse": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "paged_chunk": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def paged_view_rows(pool, table, page: int):
    """Dense per-slot view of one layer's pool: ``pool`` ``[P, Hkv, page,
    Dh]`` read through ``table`` ``[S, M]`` → ``[S, Hkv, M·page, Dh]``.
    Unmapped cells (id 0) read the trash page, whose garbage sits at masked
    positions only."""
    g = pool[table.to(torch.int64)]                  # [S, M, Hkv, page, Dh]
    S, M, Hkv, pg, Dh = g.shape
    if pg != page:
        raise ValueError(f"pool pages hold {pg} rows, page is {page}")
    return g.permute(0, 2, 1, 3, 4).reshape(S, Hkv, M * pg, Dh)


# -- plain versions (CPU path and oracle) -------------------------------------


def paged_decode_reference_lse(q, kp, vp, table, pos, page: int, window=None):
    """Single-token paged decode attention: ``q`` ``[S, Hkv, G, Dh]``,
    ``pos`` a scalar or ``[S]`` → ``(out [S, Hkv, G, Dh] f32, lse [S, Hkv,
    G] f32)``. Exactly ``decode_attention_reference_lse`` on the gathered
    view."""
    k = paged_view_rows(kp, table, page)
    v = paged_view_rows(vp, table, page)
    return decode_attention_reference_lse(q, k, v, pos, window=window)


def paged_decode_reference(q, kp, vp, table, pos, page: int, window=None):
    return paged_decode_reference_lse(q, kp, vp, table, pos, page, window)[0]


def paged_chunk_reference(q, kp, vp, table, pos0, page: int, window=None):
    """Multi-row paged attention: ``q`` ``[S, Hkv, G, C, Dh]``, query ``c``
    of slot ``s`` at position ``pos0[s] + c`` (``pos0`` a scalar or
    ``[S]``) → ``[S, Hkv, G, C, Dh]`` f32. Exactly the dense
    ``decode_chunk`` attention (``chunk_attention_reference``) on the
    gathered view."""
    S, C = q.shape[0], q.shape[3]
    k = paged_view_rows(kp, table, page)
    v = paged_view_rows(vp, table, page)
    base = torch.as_tensor(pos0, device=q.device).to(torch.int64)
    pos_b = base.reshape(-1, 1).expand(S, 1) + torch.arange(C, device=q.device)
    return chunk_attention_reference(q, k, v, pos_b, window)


# -- the CUDA kernels -----------------------------------------------------------


def _check_pool(name, q, kp, vp, table, page: int, window):
    """Shared validation of the two wrappers; returns ``(P, Hkv, Dh, M)``."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (kp, vp, table))):
        raise ValueError(f"{name} needs q, the pools and the table on one "
                         f"CUDA device")
    if kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"bad pools k {tuple(kp.shape)} v {tuple(vp.shape)}")
    P, Hkv, pg, Dh = kp.shape
    if pg != int(page):
        raise ValueError(f"pool pages hold {pg} rows, page is {page}")
    if kp.dtype not in (torch.float32, torch.bfloat16) or vp.dtype != kp.dtype:
        raise ValueError(f"pool dtype must be float32 or bfloat16, got "
                         f"{kp.dtype}/{vp.dtype}")
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("the pools must be contiguous")
    if (table.dim() != 2 or table.dtype != torch.int32
            or not table.is_contiguous()):
        raise ValueError("the table must be a contiguous [S, M] int32 tensor")
    if not 1 <= Dh <= _MAX_DH:
        raise ValueError(f"head dim {Dh} not in [1, {_MAX_DH}]")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return P, Hkv, Dh, table.shape[1]


def _rows(pos, S: int, dev, name: str):
    """A scalar, 0-d or ``[S]`` position as a contiguous int32 ``[S]`` tensor
    on ``dev`` (no host sync)."""
    if not torch.is_tensor(pos):
        return torch.full((S,), int(pos), dtype=torch.int32, device=dev)
    if pos.device != dev or pos.dim() > 1:
        raise ValueError(f"{name} must be a scalar or [S] tensor on q's device")
    return pos.to(torch.int32).reshape(-1).expand(S).contiguous()


def paged_flash_decode_lse(q, kp, vp, table, pos, page: int, window=None,
                           interpret: bool = False):
    """The K5-decode kernel: ``(out, lse)`` as
    :func:`paged_decode_reference_lse`, read straight out of the pool.
    ``interpret`` is the reference's Pallas knob, accepted in its place and
    ignored.

    ``q`` ``[S, Hkv, G, Dh]`` float (cast to float32), pools float32 or
    bfloat16 and contiguous, ``table`` int32 ``[S, M]``, ``pos`` a Python
    int, 0-d or ``[S]`` integer tensor with entries ``>= 0``. Raises on
    anything the kernel does not take, CPU tensors included; counts each
    launch in ``paged_flash_decode_lse.launches``."""
    P, Hkv, Dh, M = _check_pool("paged_flash_decode_lse", q, kp, vp, table,
                                page, window)
    if q.dim() != 4 or q.shape[1] != Hkv or q.shape[3] != Dh:
        raise ValueError(f"q {tuple(q.shape)} does not match the pool "
                         f"{tuple(kp.shape)}")
    S, _, G, _ = q.shape
    if table.shape[0] != S:
        raise ValueError(f"table has {table.shape[0]} rows for {S} slots")
    smem = _decode_smem(G, Dh, kp.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"group {G} x head dim {Dh} needs {smem} bytes of "
                         f"shared memory, more than {_SMEM_LIMIT}")
    dev = q.device
    pos_t = _rows(pos, S, dev, "pos")
    q32 = q.to(torch.float32).contiguous()
    T = M * int(page)
    n_split = _splits(S, Hkv, T,
                      torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=dev)
    o_part = torch.empty((S, Hkv, n_split, G, Dh), **f32)
    m_part = torch.empty((S, Hkv, n_split, G), **f32)
    l_part = torch.empty((S, Hkv, n_split, G), **f32)
    out = torch.empty((S, Hkv, G, Dh), **f32)
    lse = torch.empty((S, Hkv, G), **f32)
    lib = _build.load("paged_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.paged_decode_lse(
            q32.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            pos_t.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), out.data_ptr(), lse.data_ptr(),
            S, Hkv, G, Dh, P, int(page), M,
            -1 if window is None else int(window), n_split,
            min(_ALIGN, int(page)),
            float(Dh ** -0.5), int(kp.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "paged_flash_decode_lse")
    paged_flash_decode_lse.launches += 1
    return out, lse


paged_flash_decode_lse.launches = 0


def paged_flash_decode(q, kp, vp, table, pos, page: int, window=None,
                       interpret: bool = False):
    return paged_flash_decode_lse(q, kp, vp, table, pos, page, window)[0]


def paged_flash_chunk(q, kp, vp, table, pos0, page: int, window=None,
                      interpret: bool = False):
    """The K5-chunk kernel: as :func:`paged_chunk_reference`, read straight
    out of the pool. ``q`` ``[S, Hkv, G, C, Dh]`` float (cast to float32),
    ``pos0`` a Python int, 0-d or ``[S]`` integer tensor; the rest, and
    ``interpret``, as :func:`paged_flash_decode_lse`. Counts each launch in
    ``paged_flash_chunk.launches``."""
    P, Hkv, Dh, M = _check_pool("paged_flash_chunk", q, kp, vp, table,
                                page, window)
    if q.dim() != 5 or q.shape[1] != Hkv or q.shape[4] != Dh:
        raise ValueError(f"q {tuple(q.shape)} does not match the pool "
                         f"{tuple(kp.shape)}")
    S, _, G, C, _ = q.shape
    if table.shape[0] != S:
        raise ValueError(f"table has {table.shape[0]} rows for {S} slots")
    dev = q.device
    pos_t = _rows(pos0, S, dev, "pos0")
    q32 = q.to(torch.float32).contiguous()
    out = torch.empty((S, Hkv, G, C, Dh), dtype=torch.float32, device=dev)
    lib = _build.load("paged_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.paged_chunk(
            q32.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            pos_t.data_ptr(), out.data_ptr(), S, Hkv, G, C, Dh, P, int(page),
            M, -1 if window is None else int(window), float(Dh ** -0.5),
            int(kp.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "paged_flash_chunk")
    paged_flash_chunk.launches += 1
    return out


paged_flash_chunk.launches = 0


# -- dispatchers ------------------------------------------------------------------
#
# The kernel for CUDA tensors (it raises outside what it takes: there is no
# page-size condition like the TPU's sublane rule), the plain version for
# CPU tensors.


def paged_decode_attention_lse(q, kp, vp, table, pos, page: int, window=None):
    if q.is_cuda:
        return paged_flash_decode_lse(q, kp, vp, table, pos, page, window)
    return paged_decode_reference_lse(q, kp, vp, table, pos, page, window)


def paged_decode_attention(q, kp, vp, table, pos, page: int, window=None):
    return paged_decode_attention_lse(q, kp, vp, table, pos, page, window)[0]


def paged_chunk_attention(q, kp, vp, table, pos0, page: int, window=None):
    if q.is_cuda:
        return paged_flash_chunk(q, kp, vp, table, pos0, page, window)
    return paged_chunk_reference(q, kp, vp, table, pos0, page, window)
