"""Flash decode: grouped KV-cache attention for one query position per row
(port of ``elephas_tpu/ops/flash_decode.py``).

:func:`decode_attention` / :func:`decode_attention_lse` are the dispatchers
the model calls: on CUDA tensors they launch the split-K kernel in
``csrc/flash_decode.cu`` (:func:`flash_decode_lse`; its body, and the split
rule below, are shared with the paged K5-decode through
``csrc/decode_split.cuh``); on CPU tensors they run
:func:`decode_attention_reference_lse`, the plain PyTorch version that is
also the kernel's oracle. Shapes follow the reference: ``q`` ``[B, Hkv, G,
Dh]``, ``k``/``v`` ``[B, Hkv, T, Dh]``, ``pos`` a scalar or per-row ``[B]``;
the result is float32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_BLOCK_T = 256
_SUBLANE = 8
_MAX_DH = 128
_SMEM_LIMIT = 227 * 1024
# The split-K decode kernels (csrc/decode_split.cuh: this K4 and the paged
# K5-decode): a split's piece is a whole number of units of _ALIGN rows (or
# of one page, where a page is smaller); head dims up to 64, 128 and 256
# walk tiles of 32, 32 and 16 key rows (DecodeTile); a block takes up to 8
# query rows of a group; the cp.async ring holds 2 tiles
_ALIGN = 16
_DECODE_CLASSES = ((64, 32), (128, 32), (256, 16))
_DECODE_MAX_G = 8
_DECODE_STAGES = 2
_DECODE_WARPS = 4

_SIGNATURES = {
    "flash_decode_lse": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _pad_up(n: int, m: int) -> int:
    return -(-int(n) // int(m)) * int(m)


def aligned_cache_length(length: int) -> int:
    """Smallest cache length >= ``length`` that the reference's TPU kernel
    blocks without padding (a copy of the reference's rule, so the two
    packages allocate caches of the same shape). Extra positions are
    masked by ``pos``."""
    bt = min(_BLOCK_T, _pad_up(int(length), _SUBLANE))
    return _pad_up(int(length), bt)


# -- plain version (CPU path and oracle) ------------------------------------


def decode_attention_reference_lse(q, k, v, pos, window=None,
                                   ring: bool = False):
    """Grouped decode attention returning ``(out [B, Hkv, G, Dh] f32, lse
    [B, Hkv, G] f32)``; ``lse`` is the logsumexp of the masked scaled
    scores. Row b sees cache slots ``0..pos[b]``, restricted to the last
    ``window`` of them under a sliding window. ``ring=True`` (requires
    ``window``): the cache is a rolling buffer of ``T`` slots and slot
    ``s`` is visible iff its age ``(pos - s) mod T`` is ``< min(window,
    pos + 1)``."""
    dh = q.shape[-1]
    T = k.shape[2]
    scores = torch.einsum("bkgd,bktd->bkgt", q.to(torch.float32),
                          k.to(torch.float32)) * (dh ** -0.5)
    pos_rows = torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1, 1)
    slots = torch.arange(T, device=q.device)[None, None, None, :]
    if ring:
        if window is None:
            raise ValueError("ring cache attention requires a window")
        age = torch.remainder(pos_rows - slots, T)
        mask = age < torch.clamp(pos_rows + 1, max=int(window))
    else:
        mask = slots <= pos_rows
        if window is not None:
            mask = mask & (slots > pos_rows - int(window))
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.to(torch.float32)) / l[..., None]
    return out, m + torch.log(l)


def decode_attention_reference(q, k, v, pos, window=None, ring: bool = False):
    """:func:`decode_attention_reference_lse` without the lse."""
    return decode_attention_reference_lse(q, k, v, pos, window, ring)[0]


def chunk_attention_reference(q, k, v, pos_b, window=None):
    """Multi-row cached attention, the block ``decode_chunk`` runs: ``q``
    ``[B, Hkv, G, S, Dh]`` (S queries per row at absolute positions ``pos_b``
    ``[B, S]``) against the cache ``k``/``v`` ``[B, Hkv, T, Dh]``; query
    ``(b, s)`` sees slots ``0..pos_b[b, s]``, cut to the last ``window`` of
    them under a sliding window. A plain masked softmax over the whole cache
    → ``[B, Hkv, G, S, Dh]`` float32. The paged chunk path calls this same
    function on its gathered view, which keeps paged and dense bitwise equal
    on the CPU."""
    dh = q.shape[-1]
    T = k.shape[2]
    slots = torch.arange(T, device=q.device)[None, None, :]
    pos3 = pos_b[:, :, None]
    visible = slots <= pos3
    if window is not None:
        visible = visible & (slots > pos3 - int(window))
    scores = torch.einsum("bkgsd,bktd->bkgst", q.to(torch.float32),
                          k.to(torch.float32)) * (dh ** -0.5)
    probs = torch.softmax(
        scores.masked_fill(~visible[:, None, None], float("-inf")), dim=-1)
    return torch.einsum("bkgst,bktd->bkgsd", probs, v.to(torch.float32))


# -- the CUDA kernel ----------------------------------------------------------


def _splits(S: int, Hkv: int, T: int, n_sm: int) -> int:
    """The split count of the decode kernels for ``S`` slots, ``Hkv`` KV
    heads and ``T`` cached positions (the dense cache length, or a table's
    M·page): about four blocks an SM, capped only so that no piece of a
    full cache is shorter than one ``_ALIGN``-row unit. It depends on the
    grid alone; each block cuts its own piece of its slot's visible range
    on the device (:func:`decode_pieces`), so a short slot spreads over
    every split."""
    want = max(1, -(-4 * n_sm // max(S * Hkv, 1)))
    return min(want, max(1, T // _ALIGN))


def decode_range(pos: int, T: int, window=None, ring: bool = False):
    """The logical rows ``[lo, hi)`` a slot at ``pos`` sees in a cache of
    ``T`` positions (empty when ``lo >= hi``). A ring cache: the ``n =
    min(window, pos + 1, T)`` positions ending at ``pos``, position ``j`` in
    slot ``j mod T``. Otherwise ``hi = min(pos, T - 1) + 1`` and, under a
    window, ``lo = max(0, pos - window + 1)`` from the unclipped ``pos``, as
    the plain versions' mask has it."""
    pos = int(pos)
    if ring:
        n = min(int(window), pos + 1, T)
        return pos - n + 1, pos + 1
    lo = 0 if window is None else max(0, pos - int(window) + 1)
    return lo, min(pos, T - 1) + 1


def decode_pieces(pos: int, T: int, n_split: int, page: int, window=None,
                  ring: bool = False):
    """The pieces ``[(a, b), ...]`` (one per split, in split order) that the
    decode kernels' blocks cut from the visible range ``[lo, hi)``
    (:func:`decode_range`) of a slot at ``pos``. The range is ``U =
    ceil((hi - lo) / A)`` units of ``A = min(_ALIGN, page)`` rows counted
    from ``lo``; split ``i`` takes units ``[i U / n, (i + 1) U / n)`` (floor
    division), cut at ``hi``. The device code (``decode_split_kernel``)
    computes the same from the ``A`` the wrapper passes; a dense cache is
    one page of ``T`` rows."""
    A = min(_ALIGN, page)
    lo, hi = decode_range(pos, T, window, ring)
    units = max(0, -(-(hi - lo) // A))
    return [(lo + i * units // n_split * A,
             min(hi, lo + (i + 1) * units // n_split * A))
            for i in range(n_split)]


def _decode_smem(G: int, Dh: int, itemsize: int) -> int:
    """Bytes of shared memory a decode block takes (``DecodeSmem`` in
    ``decode_split.cuh``): the ring of K and V tiles (or, after the loop,
    the warps' merge rows, whichever is larger), q in float32 and the ring
    of page ids."""
    dhc, bt = next(c for c in _DECODE_CLASSES if Dh <= c[0])
    maxg = next(g for g in (1, 2, 4, _DECODE_MAX_G) if min(G, _DECODE_MAX_G) <= g)
    lpk = 32 * _DECODE_WARPS // bt
    c16 = -(-Dh * itemsize // 16)
    ld16 = c16 if lpk >= 8 else c16 + (lpk - c16 % 8) % 8
    ring = _DECODE_STAGES * 2 * bt * ld16 * 16
    merge = 4 * _DECODE_WARPS * maxg * (dhc + 2)
    q = 4 * maxg * c16 * (16 // itemsize)
    return max(ring, merge) + q + 4 * _DECODE_STAGES * (bt + 1)


def flash_decode_lse(q, k, v, pos, interpret: bool = False, window=None,
                     ring: bool = False):
    """The CUDA kernel: ``(out, lse)`` as :func:`decode_attention_reference_lse`.
    ``interpret`` is the reference's Pallas knob, accepted and ignored.

    ``q`` float (cast to float32), ``k``/``v`` float32 or bfloat16 and
    contiguous (a copy would recopy the whole cache every step), ``pos`` a
    Python int, a 0-d or a ``[B]`` integer tensor on the same device, every
    entry ``>= 0``. Raises on anything the kernel does not take; counts
    each launch in ``flash_decode_lse.launches``."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_decode_lse needs q, k, v on one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Hkv, G, Dh = q.shape
    T = k.shape[2]
    if k.shape[0] != B or k.shape[1] != Hkv or k.shape[3] != Dh:
        raise ValueError(f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if not 1 <= Dh <= _MAX_DH:
        raise ValueError(f"head dim {Dh} not in [1, {_MAX_DH}]")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise ValueError(f"cache dtype must be float32 or bfloat16, got "
                         f"{k.dtype}/{v.dtype}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous")
    if ring and window is None:
        raise ValueError("ring cache attention requires a window")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    smem = _decode_smem(G, Dh, k.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"group {G} x head dim {Dh} needs {smem} bytes of "
                         f"shared memory, more than {_SMEM_LIMIT}")
    dev = q.device
    if not torch.is_tensor(pos):
        pos_t = torch.full((B,), int(pos), dtype=torch.int32, device=dev)
    else:
        if pos.device != dev or pos.dim() > 1:
            raise ValueError("pos must be a scalar or [B] tensor on q's device")
        pos_t = pos.to(torch.int32).reshape(-1).expand(B).contiguous()
    q32 = q.to(torch.float32).contiguous()
    n_split = _splits(
        B, Hkv, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=dev)
    o_part = torch.empty((B, Hkv, n_split, G, Dh), **f32)
    m_part = torch.empty((B, Hkv, n_split, G), **f32)
    l_part = torch.empty((B, Hkv, n_split, G), **f32)
    out = torch.empty((B, Hkv, G, Dh), **f32)
    lse = torch.empty((B, Hkv, G), **f32)
    lib = _build.load("flash_decode", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.flash_decode_lse(
            q32.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
            o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Hkv, G, Dh, T,
            -1 if window is None else int(window), int(bool(ring)),
            n_split, min(_ALIGN, T), float(Dh ** -0.5),
            int(k.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "flash_decode_lse")
    flash_decode_lse.launches += 1
    return out, lse


flash_decode_lse.launches = 0


def flash_decode(q, k, v, pos, interpret: bool = False, window=None,
                 ring: bool = False):
    """The CUDA kernel without the lse: :func:`flash_decode_lse`'s ``out``
    (the reference's entry of the same name and signature)."""
    return flash_decode_lse(q, k, v, pos, interpret, window, ring)[0]


# -- dispatchers ----------------------------------------------------------------


def decode_attention_lse(q, k, v, pos, window=None, ring: bool = False):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return flash_decode_lse(q, k, v, pos, window=window, ring=ring)
    return decode_attention_reference_lse(q, k, v, pos, window, ring)


def decode_attention(q, k, v, pos, window=None, ring: bool = False):
    """:func:`decode_attention_lse` without the lse."""
    return decode_attention_lse(q, k, v, pos, window, ring)[0]
