"""Flash attention for training and prefill, forward and backward (port of
``elephas_tpu/ops/flash_attention.py`` and ``elephas_tpu/ops/pallas_flash.py``).

The public functions keep the JAX layout, ``q`` ``[B, T, H, Dh]`` and
``k``/``v`` ``[B, T, Hkv, Dh]`` with ``Hkv`` dividing ``H`` (grouped-query
attention: query head ``h`` reads KV head ``h // (H / Hkv)``):

- :func:`flash_attention` → ``[B, T, H, Dh]`` in ``q``'s dtype;
- :func:`flash_attention_with_lse` → ``(o, lse [B, T, H] float32)``,
  differentiable in both outputs (the lse cotangent folds into the
  FlashAttention-2 ``Δ`` term as ``Δ − g_lse``);
- :func:`attention_reference` and :func:`repeat_kv_heads`, copies of the
  reference's oracle helpers.

Both differentiable entries run one ``torch.autograd.Function`` whose
forward saves only ``(q, k, v, o, lse)``. On CUDA tensors it launches the
three hand-written kernels in ``csrc/flash_attention.cu``:
:func:`flash_attention_fwd` (K2-fwd), :func:`flash_attention_dq` (K2-dq)
and :func:`flash_attention_dkv` (K2-dkv). On CPU tensors it runs their
plain versions: :func:`attention_fwd_reference`, a masked softmax over all
keys in float32, and :func:`attention_bwd_reference`, the FlashAttention-2
backward from the saved lse (``_flash_bwd``'s math without the block
scan). The plain versions are also the kernels' oracles.

``causal`` masks key ``j > i`` for query ``i``; ``window`` (causal only)
keeps keys ``(i - window, i]``, the Mistral convention. Scores, softmax
and every sum run in float32; bfloat16 inputs give bfloat16 outputs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_MAX_DH = 256

_SIGNATURES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_attention_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_attention_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def repeat_kv_heads(x, n_heads: int, axis: int = -2):
    """Grouped-query attention support: broadcast ``Hkv`` KV heads up to
    ``n_heads`` along ``axis`` (identity when equal); KV head ``j`` becomes
    query heads ``j*G .. j*G + G - 1``."""
    hkv = x.shape[axis]
    if hkv == n_heads:
        return x
    if n_heads % hkv:
        raise ValueError(
            f"KV head count {hkv} must divide query head count {n_heads}")
    return torch.repeat_interleave(x, n_heads // hkv, dim=axis)


def _visible(tq: int, tk: int, causal: bool, window, device):
    """``[tq, tk]`` keep-mask of the (causal, windowed) key range, or
    ``None`` when every key is visible."""
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    if not causal:
        return None
    qi = torch.arange(tq, device=device)[:, None]
    kj = torch.arange(tk, device=device)[None, :]
    keep = kj <= qi
    if window is not None:
        keep = keep & (kj > qi - int(window))
    return keep


def _scores(q, k, causal, window):
    """Masked float32 scores ``[B, H, T, T]`` (``-inf`` where hidden) and
    the KV heads repeated to ``H``."""
    H = q.shape[2]
    kr = repeat_kv_heads(k, H).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kr) \
        * (q.shape[-1] ** -0.5)
    keep = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    return s, kr


def attention_reference(q, k, v, causal: bool = False, window=None):
    """Plain full attention, the single-device oracle: ``q`` ``[B, T, H,
    D]``, ``k``/``v`` with ``H`` or fewer (divisor) KV heads → ``[B, T, H,
    D]`` in ``q``'s dtype; scores, softmax and the value sum in float32.
    Differentiable by autograd (the ``attn="dense"`` path)."""
    s, _ = _scores(q, k, causal, window)
    probs = torch.softmax(s, dim=-1)
    vr = repeat_kv_heads(v, q.shape[2]).to(torch.float32)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vr).to(q.dtype)


# -- plain versions of the three kernels (CPU path and oracle) ---------------


def attention_fwd_reference(q, k, v, causal: bool = False, window=None):
    """Plain K2-fwd: ``(o [B, T, H, Dh] in q's dtype, lse [B, H, T]
    float32)``, a masked softmax over all keys in float32."""
    s, _ = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    vr = repeat_kv_heads(v, q.shape[2]).to(torch.float32)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype), lse


def attention_bwd_reference(q, k, v, do, lse, delta, causal: bool = False,
                            window=None):
    """Plain K2-dq and K2-dkv: the FlashAttention-2 backward from the saved
    ``lse`` ``[B, H, T]`` and ``delta`` ``[B, H, T]`` (``Σ_d dO·O`` minus
    the lse cotangent): ``p = exp(s − lse)``, ``dv = pᵀ·dO``, ``ds =
    p·(dO·vᵀ − Δ)·scale``, ``dq = ds·k``, ``dk = dsᵀ·q``, with dk and dv
    summed over each GQA group. Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    s, kr = _scores(q, k, causal, window)
    p = torch.exp(s - lse[..., None])
    dof = do.to(torch.float32)
    vr = repeat_kv_heads(v, H).to(torch.float32)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta[..., None]) * (Dh ** -0.5)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32))
    if Hkv != H:
        dk = dk.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)
        dv = dv.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels ------------------------------------------------------------


def _check(q, k, v, causal, window, what: str):
    """Validate the kernels' common inputs; returns ``(B, T, H, Hkv, Dh,
    window_int)``."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what} needs q, k, v on one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != Dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"KV head count {Hkv} must divide query head count {H}")
    if not 1 <= Dh <= _MAX_DH:
        raise ValueError(f"head dim {Dh} not in [1, {_MAX_DH}]")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    return B, T, H, Hkv, Dh, -1 if window is None else int(window)


def _check_stats(t, B, H, T, device, name):
    if (t.dtype != torch.float32 or t.device != device
            or tuple(t.shape) != (B, H, T)):
        raise ValueError(f"{name} must be float32 [{B}, {H}, {T}] on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _launch(fn: str, *args):
    lib = _build.load("flash_attention", _SIGNATURES)
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, fn)


def flash_attention_fwd(q, k, v, causal: bool = False, window=None):
    """K2-fwd, the CUDA kernel: ``(o, lse)`` as
    :func:`attention_fwd_reference`. Raises on anything the kernel does not
    take; counts each launch in ``flash_attention_fwd.launches``."""
    B, T, H, Hkv, Dh, w = _check(q, k, v, causal, window, "flash_attention_fwd")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), lse.data_ptr(), B, T, H, Hkv, Dh, int(causal), w,
                float(Dh ** -0.5), int(q.dtype == torch.bfloat16))
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _bwd_inputs(q, k, v, do, lse, delta, causal, window, what):
    B, T, H, Hkv, Dh, w = _check(q, k, v, causal, window, what)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: {do.dtype} {tuple(do.shape)}")
    lse = _check_stats(lse, B, H, T, q.device, "lse")
    delta = _check_stats(delta, B, H, T, q.device, "delta")
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse, delta, (B, T, H, Hkv, Dh, int(causal), w), float(Dh ** -0.5))


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = False,
                       window=None):
    """K2-dq, the CUDA kernel: ``dq`` as :func:`attention_bwd_reference`,
    from the saved ``lse`` and ``delta`` (both ``[B, H, T]`` float32).
    Counts each launch in ``flash_attention_dq.launches``."""
    q, k, v, do, lse, delta, dims, scale = _bwd_inputs(
        q, k, v, do, lse, delta, causal, window, "flash_attention_dq")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_attention_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                *dims, scale, int(q.dtype == torch.bfloat16))
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = False,
                        window=None):
    """K2-dkv, the CUDA kernel: ``(dk, dv)`` as
    :func:`attention_bwd_reference`, summed over each GQA group inside the
    kernel. Counts each launch in ``flash_attention_dkv.launches``."""
    q, k, v, do, lse, delta, dims, scale = _bwd_inputs(
        q, k, v, do, lse, delta, causal, window, "flash_attention_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_attention_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *dims, scale, int(q.dtype == torch.bfloat16))
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


# -- autograd --------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """``(o, lse [B, H, T])`` with the FlashAttention-2 backward: the
    kernels for CUDA tensors, their plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        fwd = flash_attention_fwd if q.is_cuda else attention_fwd_reference
        o, lse = fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        # Δ = Σ_d dO·O, in torch as the reference computes it in XLA; an
        # lse cotangent adds p·g_lse to ds, which is Δ → Δ − g_lse
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
        delta = delta.transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse
        delta = delta.contiguous()
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.window)
        if q.is_cuda:
            dq = flash_attention_dq(*args)
            dk, dv = flash_attention_dkv(*args)
        else:
            dq, dk, dv = attention_bwd_reference(*args)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False, window=None):
    """Exact attention returning ``(o [B, T, H, Dh], lse [B, T, H]
    float32)``, differentiable in both (the building block of a
    cross-shard softmax merge)."""
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    o, lse = _FlashAttention.apply(q, k, v, bool(causal),
                                   None if window is None else int(window))
    return o, lse.transpose(1, 2)


def flash_attention(q, k, v, causal: bool = False, window=None):
    """Exact attention over ``q`` ``[B, T, H, Dh]`` and ``k``/``v`` with a
    divisor KV head count → ``[B, T, H, Dh]`` in ``q``'s dtype; the
    flash-attention kernels on the card (KV heads never repeated), the
    plain versions on the CPU. Equals :func:`attention_reference` to
    float32 accumulation, gradients included."""
    return flash_attention_with_lse(q, k, v, causal, window)[0]
