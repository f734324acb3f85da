"""Flash decode: grouped KV-cache attention for one query position per row
(port of ``elephas_tpu/ops/flash_decode.py``).

:func:`decode_attention` / :func:`decode_attention_lse` are the dispatchers
the model calls: on CUDA tensors they launch the split-K kernel in
``csrc/flash_decode.cu`` (:func:`flash_decode_lse`); on CPU tensors they run
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
_TILE = 64        # cache slots per shared-memory tile (kTile in the .cu)
_MAX_DH = 128
_SMEM_LIMIT = 227 * 1024

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


# -- the CUDA kernel ----------------------------------------------------------


def _splits(B: int, Hkv: int, T: int, n_sm: int):
    """``(n_split, chunk)``: split T so the grid has about four blocks per SM
    at small batch, each chunk a whole number of tiles."""
    n_tiles = -(-T // _TILE)
    want = max(1, -(-4 * n_sm // max(B * Hkv, 1)))
    chunk = -(-n_tiles // min(n_tiles, want)) * _TILE
    return -(-T // chunk), chunk


def flash_decode_lse(q, k, v, pos, window=None, ring: bool = False):
    """The CUDA kernel: ``(out, lse)`` as :func:`decode_attention_reference_lse`.

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
    smem = 4 * (2 * G * Dh + 2 * _TILE * Dh + G * _TILE + 3 * G)
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
    n_split, chunk = _splits(
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
            n_split, chunk, float(Dh ** -0.5),
            int(k.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "flash_decode_lse")
    flash_decode_lse.launches += 1
    return out, lse


flash_decode_lse.launches = 0


# -- dispatchers ----------------------------------------------------------------


def decode_attention_lse(q, k, v, pos, window=None, ring: bool = False):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return flash_decode_lse(q, k, v, pos, window=window, ring=ring)
    return decode_attention_reference_lse(q, k, v, pos, window, ring)


def decode_attention(q, k, v, pos, window=None, ring: bool = False):
    """:func:`decode_attention_lse` without the lse."""
    return decode_attention_lse(q, k, v, pos, window, ring)[0]
