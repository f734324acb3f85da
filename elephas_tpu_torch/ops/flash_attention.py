"""Flash attention for training and prefill, forward and backward (port of
``elephas_tpu/ops/flash_attention.py`` and ``elephas_tpu/ops/pallas_flash.py``).

The public functions keep the JAX layout, ``q`` ``[B, T, H, Dh]`` and
``k``/``v`` ``[B, T, Hkv, Dh]`` with ``Hkv`` dividing ``H`` (grouped-query
attention: query head ``h`` reads KV head ``h // (H / Hkv)``):

- :func:`flash_attention` → ``[B, T, H, Dh]`` in ``q``'s dtype;
- :func:`flash_attention_tpu` → ``[B, T, H, Dh]``, the reference's Pallas
  entry under its own name and signature, on the same kernels;
- :func:`flash_attention_with_lse` → ``(o, lse [B, T, H] float32)``,
  differentiable in both outputs (the lse cotangent folds into the
  FlashAttention-2 ``Δ`` term as ``Δ − g_lse``);
- :func:`flash_attention_rope` → ``[B, T, H, Dh]``: q and k arrive
  UNROTATED with the duplicated half-split tables of
  :func:`make_rope_tables`, and the kernels rotate each tile as they load
  it (and derotate dq and dk as they store them), so the rotated q and k
  never exist in device memory;
- :func:`attention_reference` and :func:`repeat_kv_heads`, copies of the
  reference's oracle helpers.

The differentiable entries run ``torch.autograd.Function`` s whose forward
saves only ``(q, k, v, o, lse)`` (and the tables). On CUDA tensors they
launch the hand-written kernels in ``csrc/flash_attention.cu``:
:func:`flash_attention_fwd` (K2-fwd), :func:`flash_attention_dq` (K2-dq)
and :func:`flash_attention_dkv` (K2-dkv), and their rope-on-load variants
:func:`flash_attention_rope_fwd`, :func:`flash_attention_rope_dq` and
:func:`flash_attention_rope_dkv`. On CPU tensors they run the plain
versions: :func:`attention_fwd_reference`, a masked softmax over all keys
in float32, and :func:`attention_bwd_reference`, the FlashAttention-2
backward from the saved lse (``_flash_bwd``'s math without the block
scan); :func:`rope_attention_fwd_reference` and
:func:`rope_attention_bwd_reference` put :func:`_rope_apply` around them.
The plain versions are also the kernels' oracles.

``causal`` masks key ``j > i`` for query ``i``; ``window`` (causal only)
keeps keys ``(i - window, i]``, the Mistral convention. Scores, softmax
and every sum run in float32; bfloat16 inputs give bfloat16 outputs.
``block_size``, ``block_q``, ``block_k`` and ``interpret`` only steer the
reference's Pallas tiles; the port keeps them in their places and ignores
them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_MAX_DH = 256

_TAIL = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "flash_attention_fwd": [ctypes.c_void_p] * 5 + _TAIL,
    "flash_attention_dq": [ctypes.c_void_p] * 7 + _TAIL,
    "flash_attention_dkv": [ctypes.c_void_p] * 8 + _TAIL,
    # the rope variants: the same operands, then the tables c2 and s2
    "flash_attention_rope_fwd": [ctypes.c_void_p] * 7 + _TAIL,
    "flash_attention_rope_dq": [ctypes.c_void_p] * 9 + _TAIL,
    "flash_attention_rope_dkv": [ctypes.c_void_p] * 10 + _TAIL,
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


def _attention_bwd_f32(q, k, v, do, lse, delta, causal, window):
    """:func:`attention_bwd_reference` before the final casts: ``(dq, dk,
    dv)`` in float32."""
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
    return dq, dk, dv


def attention_bwd_reference(q, k, v, do, lse, delta, causal: bool = False,
                            window=None):
    """Plain K2-dq and K2-dkv: the FlashAttention-2 backward from the saved
    ``lse`` ``[B, H, T]`` and ``delta`` ``[B, H, T]`` (``Σ_d dO·O`` minus
    the lse cotangent): ``p = exp(s − lse)``, ``dv = pᵀ·dO``, ``ds =
    p·(dO·vᵀ − Δ)·scale``, ``dq = ds·k``, ``dk = dsᵀ·q``, with dk and dv
    summed over each GQA group. Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    dq, dk, dv = _attention_bwd_f32(q, k, v, do, lse, delta, causal, window)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- rotary tables and the plain rope-on-load versions --------------------------


def make_rope_tables(cos, sin):
    """``(cos, sin)`` ``[..., Dh/2]`` → the duplicated half-split tables
    ``(C2, S2)`` ``[..., Dh]`` float32, ``C2 = [cos|cos]`` and ``S2 =
    [−sin|sin]`` (see :func:`_rope_apply`). Build them once per forward,
    not once per layer."""
    c2 = torch.cat([cos, cos], -1).to(torch.float32)
    s2 = torch.cat([-sin, sin], -1).to(torch.float32)
    return c2, s2


def _rope_apply(x, c2, s2, neg: bool = False):
    """Half-split RoPE of ``x`` ``[B, T, heads, Dh]`` as ``x·C2 +
    roll_half(x)·S2`` with the ``[B, T, Dh]`` tables, in float32, the
    result in ``x``'s dtype (the reference's ``_rot``). ``neg=True`` is the
    inverse rotation (the transform is orthogonal), which maps a gradient
    with respect to the rotated tensor back to the unrotated one."""
    xf = x.to(torch.float32)
    c, s = c2[:, :, None, :], s2[:, :, None, :]
    if neg:
        s = -s
    return (xf * c + torch.roll(xf, xf.shape[-1] // 2, dims=-1) * s).to(x.dtype)


def rope_attention_fwd_reference(q, k, v, c2, s2, causal: bool = True,
                                 window=None):
    """Plain rope-on-load K2-fwd: q and k rotated (float32, rounded to
    their dtype), then :func:`attention_fwd_reference`."""
    return attention_fwd_reference(_rope_apply(q, c2, s2), _rope_apply(k, c2, s2),
                                   v, causal, window)


def rope_attention_bwd_reference(q, k, v, do, lse, delta, c2, s2,
                                 causal: bool = True, window=None):
    """Plain rope-on-load K2-dq and K2-dkv: the backward of the rotated q
    and k, with dq and dk derotated in float32 before they are rounded to
    the inputs' dtypes."""
    dq, dk, dv = _attention_bwd_f32(_rope_apply(q, c2, s2), _rope_apply(k, c2, s2),
                                    v, do, lse, delta, causal, window)
    return (_rope_apply(dq, c2, s2, neg=True).to(q.dtype),
            _rope_apply(dk, c2, s2, neg=True).to(k.dtype), dv.to(v.dtype))


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


def _check_tables(c2, s2, B, T, Dh, device):
    """The rope tables as the kernels read them: float32 ``[B, T, Dh]``,
    contiguous (they are read in place, never copied), ``Dh`` even."""
    if Dh % 2:
        raise ValueError(f"rotary attention needs an even head dim, got {Dh}")
    for name, t in (("c2", c2), ("s2", s2)):
        if (t.dtype != torch.float32 or t.device != device
                or tuple(t.shape) != (B, T, Dh)):
            raise ValueError(f"rope table {name} must be float32 [{B}, {T}, {Dh}] "
                             f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"rope table {name} must be contiguous")
    return c2.data_ptr(), s2.data_ptr()


def _launch(fn: str, *args):
    lib = _build.load("flash_attention", _SIGNATURES)
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, fn)


def _fwd(name, q, k, v, tables, causal, window):
    B, T, H, Hkv, Dh, w = _check(q, k, v, causal, window, name)
    rope = () if tables is None else _check_tables(*tables, B, T, Dh, q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), *rope,
                o.data_ptr(), lse.data_ptr(), B, T, H, Hkv, Dh, int(causal), w,
                float(Dh ** -0.5), int(q.dtype == torch.bfloat16))
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = False, window=None):
    """K2-fwd, the CUDA kernel: ``(o, lse)`` as
    :func:`attention_fwd_reference`. Raises on anything the kernel does not
    take; counts each launch in ``flash_attention_fwd.launches``."""
    out = _fwd("flash_attention_fwd", q, k, v, None, causal, window)
    _build.count_launch(flash_attention_fwd)
    return out


flash_attention_fwd.launches = 0


def flash_attention_rope_fwd(q, k, v, c2, s2, causal: bool = True,
                             window=None):
    """K2-fwd with rope on load, the CUDA kernel: ``(o, lse)`` as
    :func:`rope_attention_fwd_reference`, from the unrotated q and k and
    the ``[B, T, Dh]`` float32 tables. Counts each launch in
    ``flash_attention_rope_fwd.launches``."""
    out = _fwd("flash_attention_rope_fwd", q, k, v, (c2, s2), causal, window)
    _build.count_launch(flash_attention_rope_fwd)
    return out


flash_attention_rope_fwd.launches = 0


def _bwd_inputs(q, k, v, do, lse, delta, tables, causal, window, what):
    B, T, H, Hkv, Dh, w = _check(q, k, v, causal, window, what)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: {do.dtype} {tuple(do.shape)}")
    lse = _check_stats(lse, B, H, T, q.device, "lse")
    delta = _check_stats(delta, B, H, T, q.device, "delta")
    rope = () if tables is None else _check_tables(*tables, B, T, Dh, q.device)
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *rope)
    return q, k, v, ptrs, (B, T, H, Hkv, Dh, int(causal), w), float(Dh ** -0.5)


def _dq(name, q, k, v, do, lse, delta, tables, causal, window):
    q, k, v, ptrs, dims, scale = _bwd_inputs(q, k, v, do, lse, delta, tables,
                                             causal, window, name)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch(name, *ptrs, dq.data_ptr(), *dims, scale,
                int(q.dtype == torch.bfloat16))
    return dq


def _dkv(name, q, k, v, do, lse, delta, tables, causal, window):
    q, k, v, ptrs, dims, scale = _bwd_inputs(q, k, v, do, lse, delta, tables,
                                             causal, window, name)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch(name, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, scale,
                int(q.dtype == torch.bfloat16))
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = False,
                       window=None):
    """K2-dq, the CUDA kernel: ``dq`` as :func:`attention_bwd_reference`,
    from the saved ``lse`` and ``delta`` (both ``[B, H, T]`` float32).
    Counts each launch in ``flash_attention_dq.launches``."""
    dq = _dq("flash_attention_dq", q, k, v, do, lse, delta, None, causal, window)
    _build.count_launch(flash_attention_dq)
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = False,
                        window=None):
    """K2-dkv, the CUDA kernel: ``(dk, dv)`` as
    :func:`attention_bwd_reference`, summed over each GQA group inside the
    kernel. Counts each launch in ``flash_attention_dkv.launches``."""
    out = _dkv("flash_attention_dkv", q, k, v, do, lse, delta, None, causal,
               window)
    _build.count_launch(flash_attention_dkv)
    return out


flash_attention_dkv.launches = 0


def flash_attention_rope_dq(q, k, v, do, lse, delta, c2, s2,
                            causal: bool = True, window=None):
    """K2-dq with rope on load, the CUDA kernel: ``dq`` (derotated) as
    :func:`rope_attention_bwd_reference`. Counts each launch in
    ``flash_attention_rope_dq.launches``."""
    dq = _dq("flash_attention_rope_dq", q, k, v, do, lse, delta, (c2, s2),
             causal, window)
    _build.count_launch(flash_attention_rope_dq)
    return dq


flash_attention_rope_dq.launches = 0


def flash_attention_rope_dkv(q, k, v, do, lse, delta, c2, s2,
                             causal: bool = True, window=None):
    """K2-dkv with rope on load, the CUDA kernel: ``(dk, dv)``, dk
    derotated, as :func:`rope_attention_bwd_reference`. Counts each launch
    in ``flash_attention_rope_dkv.launches``."""
    out = _dkv("flash_attention_rope_dkv", q, k, v, do, lse, delta, (c2, s2),
               causal, window)
    _build.count_launch(flash_attention_rope_dkv)
    return out


flash_attention_rope_dkv.launches = 0


# -- autograd --------------------------------------------------------------------


def _delta(do, o, dlse):
    """Δ = Σ_d dO·O ``[B, H, T]``, in torch as the reference computes it in
    XLA; an lse cotangent adds p·g_lse to ds, which is Δ → Δ − g_lse."""
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse
    return delta.contiguous()


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
        args = (q, k, v, do, lse, _delta(do, o, dlse), ctx.causal, ctx.window)
        if q.is_cuda:
            dq = flash_attention_dq(*args)
            dk, dv = flash_attention_dkv(*args)
        else:
            dq, dk, dv = attention_bwd_reference(*args)
        return dq, dk, dv, None, None


class _FlashAttentionRope(torch.autograd.Function):
    """Attention of the rotated q and k from the unrotated ones: the
    rope-on-load kernels for CUDA tensors, their plain versions for CPU
    tensors. Saves the UNROTATED q and k, so the backward's inputs are
    exactly the forward's. The tables are constants (positions are not
    trained): their gradient is ``None``, as the reference's
    ``stop_gradient`` and zero cotangent make it."""

    @staticmethod
    def forward(ctx, q, k, v, c2, s2, causal, window):
        fwd = flash_attention_rope_fwd if q.is_cuda else rope_attention_fwd_reference
        o, lse = fwd(q, k, v, c2, s2, causal, window)
        ctx.save_for_backward(q, k, v, o, lse, c2, s2)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, c2, s2 = ctx.saved_tensors
        args = (q, k, v, do, lse, _delta(do, o, None), c2, s2, ctx.causal,
                ctx.window)
        if q.is_cuda:
            dq = flash_attention_rope_dq(*args)
            dk, dv = flash_attention_rope_dkv(*args)
        else:
            dq, dk, dv = rope_attention_bwd_reference(*args)
        return dq, dk, dv, None, None, None, None


def _window(causal, window):
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    return None if window is None else int(window)


def flash_attention_with_lse(q, k, v, causal: bool = False, block_q: int = 512,
                             block_k: int = 512, interpret: bool = False,
                             window=None):
    """Exact attention returning ``(o [B, T, H, Dh], lse [B, T, H]
    float32)``, differentiable in both (the building block of a
    cross-shard softmax merge). ``block_q``, ``block_k`` and ``interpret``
    are the reference's Pallas knobs, accepted and ignored."""
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), _window(causal, window))
    return o, lse.transpose(1, 2)


def flash_attention_tpu(q, k, v, causal: bool = False, block_q: int = 512,
                        block_k: int = 512, interpret: bool = False, window=None):
    """The reference's Pallas entry (``pallas_flash.flash_attention_tpu``):
    exact attention ``[B, T, H, Dh]``, differentiable, on the same kernels
    as :func:`flash_attention`. ``block_q``, ``block_k`` and ``interpret``
    are the reference's Pallas knobs, accepted and ignored."""
    return flash_attention_with_lse(q, k, v, causal, window=window)[0]


def flash_attention(q, k, v, causal: bool = False, block_size: int = 128,
                    window=None):
    """Exact attention over ``q`` ``[B, T, H, Dh]`` and ``k``/``v`` with a
    divisor KV head count → ``[B, T, H, Dh]`` in ``q``'s dtype; the
    flash-attention kernels on the card (KV heads never repeated), the
    plain versions on the CPU. Equals :func:`attention_reference` to
    float32 accumulation, gradients included. ``block_size`` is the
    reference's scan tile, accepted and ignored (the kernels use their
    own tiles)."""
    return flash_attention_with_lse(q, k, v, causal, window=window)[0]


def flash_attention_rope(q, k, v, c2, s2, causal: bool = True,
                         block_q: int = 512, block_k: int = 512,
                         interpret: bool = False, window=None):
    """Flash attention with the rotary embedding fused into the kernels:
    ``q`` ``[B, T, H, Dh]`` and ``k``/``v`` ``[B, T, Hkv, Dh]`` arrive
    UNROTATED, ``c2``/``s2`` are the ``[B, T, Dh]`` float32 tables of
    :func:`make_rope_tables`. Equal to rotating q and k first and calling
    :func:`flash_attention`, for the q, k and v gradients too; the tables
    get no gradient. ``block_q``, ``block_k`` and ``interpret`` are the
    reference's Pallas knobs, accepted and ignored."""
    return _FlashAttentionRope.apply(q, k, v, c2, s2, bool(causal),
                                     _window(causal, window))
