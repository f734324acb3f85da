#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``elephas_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. ``card``: the ``nvidia-smi`` name and power limit (also printed raw),
   then ``build``: every CUDA kernel compiled from ``elephas_tpu_torch/ops/
   csrc`` by ``nvcc`` (one process per source, all started together).
2. ``kernel``: each kernel's wrapper on the card against its plain PyTorch
   version on the same inputs, with the tolerance stated, then timed with
   CUDA events beside the plain version, one PyTorch library call that
   computes the same function (a yardstick the port never calls), and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   67 TFLOP/s float32, whichever is larger; H100 SXM data-sheet peaks):
   LayerNorm forward and backward, flash decode, and flash attention
   forward, dq and dkv (eight cases: GPT-2 training shape, ragged T, GQA,
   window, non-causal, lse cotangent, bf16 at Dh 64 and 256).
3. ``serve``: GPT-2-small at full width (random weights from a seed)
   behind ``ServingEngine(n_slots=8)``: 16 greedy requests, prompts of
   32-256 tokens, 64 new tokens each. The kernel launch counters are set to
   0 just before and read just after; the run must have launched the
   flash-decode kernel once per layer per decode step and the LayerNorm
   kernel 2L+1 times per decode step and per prefill.
4. ``cross_check``: two of those requests, 8 new tokens, on a
   ``device="cpu"`` engine with the same weights (the plain path): the
   greedy tokens agree up to the first position whose CPU top-1/top-2
   logit gap is 1e-3 or less (a near tie, where either choice is right).
5. ``profile``: ten decode steps of a full batch under ``torch.profiler``:
   device time per step by kernel and the device's busy share.
6. ``train``: GPT-2-small at full width and depth, float32, trained by
   ``build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")``
   on one fixed batch of 8 rows of 1024 tokens: 2 warm-up and 5 timed
   steps with finite, falling losses, and per timed step exactly L
   launches of each flash-attention kernel and 2L+1 of each LayerNorm
   kernel; then one step with ``vocab_block=8192`` against the dense head.
7. ``train_cross_check``: the loss and every parameter's gradient of one
   step at B=1, T=128 on the card against ``device="cpu"`` (the plain
   path), from the same weights.
8. ``generate``: greedy ``generate`` of 32 tokens after 4 prompts of 128:
   L flash-attention launches (the prefill) and L flash-decode launches
   per decode step; its tokens equal the ``ServingEngine``'s on the same
   prompts up to the first near tie (top-2 logit gap 1e-3 or less).

Then the kernel summary line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the repository around it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SEED = 0

GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024, pos_encoding="learned",
                  activation="gelu", norm="layernorm", norm_eps=1e-5,
                  attn_bias=True, ffn_bias=True, tie_embeddings=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, inputs, n_iter: int = 60) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])`` with CUDA events.
    A device-side sleep first holds the stream while the host enqueues
    every launch, so host overhead between launches does not show up as
    device time. Cycling through several input sets keeps the working set
    larger than the 50 MB L2, as the decode loop's per-layer caches are."""
    for a in inputs[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s at H100 clocks
    start.record()
    for i in range(n_iter):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


# -- phase 1 ---------------------------------------------------------------------


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    first = out.splitlines()[0]
    name, limit = (s.strip() for s in first.split(",", 1))
    return first, name, limit


# -- phase 2 ---------------------------------------------------------------------


def check_layer_norm(card):
    from elephas_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                  layer_norm_reference)

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    checks, worst = [], 0.0
    for shape, offset in (((8, 768), 0.0), ((128, 768), 0.0),
                          ((8, 1000), 0.0), ((8, 768), 1e4)):
        n, d = shape
        x = gen.normal(size=shape).astype(np.float32)
        x[0] += offset
        s = (1 + 0.1 * gen.normal(size=(d,))).astype(np.float32)
        b = gen.normal(size=(d,)).astype(np.float32)
        x, s, b = (torch.from_numpy(a).to(dev) for a in (x, s, b))
        got = fused_layer_norm(x, s, b)
        torch.cuda.synchronize()
        if offset:
            # a row at 1e4: float32 row means round differently in any two
            # implementations, so the plain version runs in float64 here
            want = layer_norm_reference(x.double(), s.double(), b.double())
        else:
            want = layer_norm_reference(x, s, b).float()
        err = float((got.double() - want.double()).abs().max())
        require(bool(torch.isfinite(got).all()), f"layer_norm {shape} not finite")
        require(err <= 1e-5, f"layer_norm {shape} offset {offset}: "
                             f"max abs err {err} > 1e-5")
        worst = max(worst, err)
        checks.append({"shape": list(shape), "row_offset": offset,
                       "max_abs_err": err, "atol": 1e-5})

    # timing at the decode shape [8, 768] (2L+1 launches a decode step)
    n, d = 8, 768
    sets = [tuple(t.to(dev) for t in (torch.randn(n, d), 1 + 0.1 * torch.randn(d),
                                      torch.randn(d))) for _ in range(4)]
    ms = device_ms(fused_layer_norm, sets)
    plain_ms = device_ms(lambda x, s, b: layer_norm_reference(x, s, b).float(), sets)
    lib_ms = device_ms(lambda x, s, b: torch.nn.functional.layer_norm(x, (d,), s, b, 1e-5), sets)
    bms, by = bound_ms((2 * n * d + 2 * d) * 4, 8 * n * d)
    row = {"name": "layer_norm_fwd", "route": "cuda",
           "source": "elephas_tpu_torch/ops/csrc/layer_norm.cu",
           "replaces": "elephas_tpu/ops/layer_norm.py:115",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "timed_shape": [n, d]}
    emit({"phase": "kernel", "kernel": "layer_norm_fwd", "checks": checks,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": bms, "bound_by": by, "card": card})
    return row


def _allclose_err(got, want, tol):
    """``(max abs error, ok)`` of ``got`` against ``want`` under
    ``|got - want| <= tol + tol * |want|`` (the reference tests' allclose
    with atol = rtol = tol)."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= tol + tol * w.abs()).all())


def check_layer_norm_bwd(card):
    """K3-bwd against the autograd backward of the plain version, at the
    train phase's B*T rows, a ragged width, and a row at 1e4 (against the
    plain version in float64: a float32 row mean rounds visibly there)."""
    from elephas_tpu_torch.ops.layer_norm import (fused_layer_norm_bwd,
                                                  layer_norm_reference)

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED + 5)
    tol = 1e-4   # the reference's own pin for these gradients
    checks, worst = [], 0.0

    def plain_grads(x, s, b, g):
        x, s, b = (t.detach().requires_grad_() for t in (x, s, b))
        return torch.autograd.grad(layer_norm_reference(x, s, b), (x, s, b), g)

    def inputs(n, d, offset=0.0):
        x = (gen.normal(size=(n, d)) * 3 + 1).astype(np.float32)
        x[0] += offset
        s = (1 + 0.1 * gen.normal(size=(d,))).astype(np.float32)
        b = gen.normal(size=(d,)).astype(np.float32)
        g = gen.normal(size=(n, d)).astype(np.float32)
        return tuple(torch.from_numpy(a).to(dev) for a in (x, s, b, g))

    for shape, offset in (((8192, 768), 0.0), ((8, 1000), 0.0), ((8, 768), 1e4)):
        x, s, b, g = inputs(*shape, offset)
        got = fused_layer_norm_bwd(x, s, g)
        torch.cuda.synchronize()
        if offset:
            want = plain_grads(x.double(), s.double(), b.double(), g.double())
        else:
            want = plain_grads(x, s, b, g)
        errs = [_allclose_err(a, w, tol) for a, w in zip(got, want)]
        err = max(e for e, _ in errs)
        for name, a in zip(("dx", "dscale", "dbias"), got):
            require(bool(torch.isfinite(a).all()), f"layer_norm_bwd {shape}: {name} not finite")
        require(all(ok for _, ok in errs),
                f"layer_norm_bwd {shape} offset {offset}: max abs err {err} "
                f"beyond atol = rtol = {tol}")
        worst = max(worst, err)
        checks.append({"shape": list(shape), "row_offset": offset,
                       "max_abs_err": err, "atol": tol, "rtol": tol})

    # timing at the train phase's shape [B*T, D] = [8192, 768]; 4 input
    # sets of 50 MB each keep the reads out of the 50 MB L2
    n, d = 8192, 768
    sets = [inputs(n, d) for _ in range(4)]
    ms = device_ms(lambda x, s, b, g: fused_layer_norm_bwd(x, s, g), sets, n_iter=40)

    def autograd_ms(fwd):
        graphs = []
        for x, s, b, g in sets:
            x, s, b = (t.detach().requires_grad_() for t in (x, s, b))
            graphs.append((fwd(x, s, b), (x, s, b), g))
        return device_ms(lambda out, args, g: torch.autograd.grad(
            out, args, g, retain_graph=True), graphs, n_iter=40)

    plain_ms = autograd_ms(layer_norm_reference)
    lib_ms = autograd_ms(lambda x, s, b: torch.nn.functional.layer_norm(x, (d,), s, b, 1e-5))
    bms, by = bound_ms((3 * n * d + 3 * d) * 4, 12 * n * d)
    row = {"name": "layer_norm_bwd", "route": "cuda",
           "source": "elephas_tpu_torch/ops/csrc/layer_norm.cu",
           "replaces": "elephas_tpu/ops/layer_norm.py:146",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "library": "autograd backward of F.layer_norm",
           "timed_shape": [n, d]}
    emit({"phase": "kernel", "kernel": "layer_norm_bwd", "checks": checks,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": bms, "bound_by": by, "card": card})
    return row


# name, B, H, Hkv, T, Dh, causal, window, dtype, lse cotangent, tolerance:
# float32 at the reference's own pin for these kernels (atol = rtol =
# 2e-5, tests/ops/test_pallas_flash.py:50), bfloat16 at its bf16 pin (2e-2,
# :70): the kernel rounds its outputs to bf16, the plain version rounds
# once from its float32 result
K2_CASES = [
    ("gpt2_train_f32", 8, 12, 12, 1024, 64, True, None, torch.float32, False, 2e-5),
    ("t1000_f32", 2, 12, 12, 1000, 64, True, None, torch.float32, False, 2e-5),
    ("gqa_h8_hkv2_dh128_f32", 2, 8, 2, 1024, 128, True, None, torch.float32, False, 2e-5),
    ("window128_f32", 2, 12, 12, 1024, 64, True, 128, torch.float32, False, 2e-5),
    ("noncausal_f32", 2, 12, 12, 1024, 64, False, None, torch.float32, False, 2e-5),
    ("with_lse_f32", 2, 12, 12, 512, 64, True, None, torch.float32, True, 2e-5),
    ("bf16_dh64", 2, 12, 12, 1024, 64, True, None, torch.bfloat16, False, 2e-2),
    ("bf16_dh256", 2, 4, 4, 512, 256, True, None, torch.bfloat16, False, 2e-2),
]


def _attn_inputs(gen, B, H, Hkv, T, Dh, dtype):
    dev = torch.device("cuda")

    def t(*shape):
        return torch.from_numpy(gen.normal(size=shape).astype(np.float32)).to(dev, dtype)

    return t(B, T, H, Dh), t(B, T, Hkv, Dh), t(B, T, Hkv, Dh), t(B, T, H, Dh)


def _visible_pairs(T, causal, window):
    """(query, key) pairs the causal bound and the window leave visible."""
    if not causal:
        return T * T
    if window is None or window >= T:
        return T * (T + 1) // 2
    return sum(min(i + 1, window) for i in range(T))


def check_flash_attention(card):
    """K2-fwd, K2-dq and K2-dkv against their plain versions on the same
    inputs (the backward kernels and the plain backward get the same lse
    and delta), for every case of ``K2_CASES``; with an lse cotangent also
    the whole differentiable ``flash_attention_with_lse`` against autograd
    of the plain forward. Then timed at the GPT-2 training shape."""
    from elephas_tpu_torch.ops.flash_attention import (
        attention_bwd_reference, attention_fwd_reference, flash_attention_dkv,
        flash_attention_dq, flash_attention_fwd, flash_attention_with_lse)

    gen = np.random.default_rng(SEED + 3)
    checks = []
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, B, H, Hkv, T, Dh, causal, window, dtype, with_lse, tol in K2_CASES:
        q, k, v, do = _attn_inputs(gen, B, H, Hkv, T, Dh, dtype)
        g_lse = (torch.from_numpy(gen.normal(size=(B, H, T)).astype(np.float32)).cuda()
                 if with_lse else torch.zeros(B, H, T, device="cuda"))
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        wo, wl = attention_fwd_reference(q, k, v, causal, window)
        delta = ((do.float() * wo.float()).sum(-1).transpose(1, 2) - g_lse).contiguous()
        dq = flash_attention_dq(q, k, v, do, wl, delta, causal, window)
        dk, dv = flash_attention_dkv(q, k, v, do, wl, delta, causal, window)
        want = attention_bwd_reference(q, k, v, do, wl, delta, causal, window)
        torch.cuda.synchronize()
        errs = {"o": _allclose_err(o, wo, tol), "lse": _allclose_err(lse, wl, tol),
                "dq": _allclose_err(dq, want[0], tol),
                "dk": _allclose_err(dk, want[1], tol),
                "dv": _allclose_err(dv, want[2], tol)}
        if with_lse:
            # the autograd Function end to end (kernels, delta, lse
            # cotangent) against autograd through the plain forward
            gl = g_lse.transpose(1, 2)
            grads = {}
            for route in ("kernel", "plain"):
                args = [t.detach().requires_grad_() for t in (q, k, v)]
                if route == "kernel":
                    out, lse_bth = flash_attention_with_lse(*args, causal=causal)
                else:
                    out, lse_bht = attention_fwd_reference(*args, causal, window)
                    lse_bth = lse_bht.transpose(1, 2)
                loss = (out.float() * do.float()).sum() + (lse_bth * gl).sum()
                grads[route] = torch.autograd.grad(loss, args)
            for n_, a, w in zip(("autograd_dq", "autograd_dk", "autograd_dv"),
                                grads["kernel"], grads["plain"]):
                errs[n_] = _allclose_err(a, w, tol)
        bad = [k_ for k_, (_, ok) in errs.items() if not ok]
        require(not bad, f"flash_attention {name}: {bad} beyond atol = rtol = {tol}: "
                         f"{ {k_: e for k_, (e, _) in errs.items()} }")
        if dtype == torch.float32:
            worst["fwd"] = max(worst["fwd"], errs["o"][0], errs["lse"][0])
            worst["dq"] = max(worst["dq"], errs["dq"][0])
            worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])
        checks.append({"case": name, "B": B, "H": H, "Hkv": Hkv, "T": T, "Dh": Dh,
                       "causal": causal, "window": window, "dtype": str(dtype),
                       "lse_cotangent": with_lse, "atol": tol, "rtol": tol,
                       "max_abs_err": {k_: e for k_, (e, _) in errs.items()}})
        del q, k, v, do, o, lse, wo, wl, delta, dq, dk, dv, want

    # timing at the GPT-2 training shape, float32, causal; two input sets
    # (100 MB each) alternate so the reads miss the 50 MB L2
    B, H, T, Dh = 8, 12, 1024, 64
    sets = []
    for _ in range(2):
        q, k, v, do = _attn_inputs(gen, B, H, H, T, Dh, torch.float32)
        o, lse = attention_fwd_reference(q, k, v, True)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        sets.append((q, k, v, do, lse, delta))
    n = 20
    fwd_ms = device_ms(lambda q, k, v, *_: flash_attention_fwd(q, k, v, True), sets, n)
    dq_ms = device_ms(lambda *a: flash_attention_dq(*a, True), sets, n)
    dkv_ms = device_ms(lambda *a: flash_attention_dkv(*a, True), sets, n)
    plain_fwd_ms = device_ms(lambda q, k, v, *_: attention_fwd_reference(q, k, v, True), sets, n)
    plain_bwd_ms = device_ms(lambda *a: attention_bwd_reference(*a, True), sets, n)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s[:4]) for s in sets]
    lib_fwd_ms = device_ms(lambda q, k, v, _: sdpa(q, k, v, is_causal=True), lib_sets, n)
    graphs = []
    for q, k, v, do in lib_sets:
        args = [t.detach().requires_grad_() for t in (q, k, v)]
        graphs.append((sdpa(*args, is_causal=True), args, do))
    lib_bwd_ms = device_ms(lambda out, args, do: torch.autograd.grad(
        out, args, do, retain_graph=True), graphs, n)
    del sets, lib_sets, graphs

    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * Dh * 4                       # one [B, T, H, Dh] f32 array
    stat = B * H * T * 4                              # one [B, H, T] f32 array
    rows = []
    for name, ms, plain_ms, lib_ms, lib, n_bytes, n_ops, err in (
            ("flash_attention_fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms,
             "F.scaled_dot_product_attention(is_causal=True)",
             4 * tensor + stat, 4 * Dh * pairs, worst["fwd"]),
            ("flash_attention_dq", dq_ms, plain_bwd_ms, lib_bwd_ms,
             "autograd backward of F.scaled_dot_product_attention (dq, dk and dv together)",
             5 * tensor + 2 * stat, 6 * Dh * pairs, worst["dq"]),
            ("flash_attention_dkv", dkv_ms, plain_bwd_ms, None, None,
             6 * tensor + 2 * stat, 8 * Dh * pairs, worst["dkv"])):
        bms, by = bound_ms(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda",
                     "source": "elephas_tpu_torch/ops/csrc/flash_attention.cu",
                     "replaces": ("elephas_tpu/ops/pallas_flash.py:211" if name.endswith("fwd")
                                  else "elephas_tpu/ops/pallas_flash.py:414"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "plain": ("attention_fwd_reference" if name.endswith("fwd") else
                               "attention_bwd_reference (dq, dk and dv together)"),
                     "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                     "library": lib,
                     "timed_shape": {"B": B, "H": H, "Hkv": H, "T": T, "Dh": Dh,
                                     "causal": True, "dtype": "float32"}})
    emit({"phase": "kernel", "kernel": "flash_attention", "checks": checks,
          "timing": [{k_: r[k_] for k_ in ("name", "ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")} for r in rows],
          "card": card})
    return rows


def _decode_inputs(gen, B, hkv, g, dh, T, dtype, pos):
    dev = torch.device("cuda")
    q = torch.from_numpy(gen.normal(size=(B, hkv, g, dh)).astype(np.float32)).to(dev)
    k = torch.from_numpy(gen.normal(size=(B, hkv, T, dh)).astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(gen.normal(size=(B, hkv, T, dh)).astype(np.float32)).to(dev, dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=dev)


def _visible(pos, T, window=None, ring=False):
    """Cache slots each row attends (what the kernel must read)."""
    out = []
    for p in pos:
        if ring:
            out.append(min(window, p + 1, T))
        else:
            hi = min(p, T - 1) + 1
            lo = 0 if window is None else max(0, p - window + 1)
            out.append(max(0, hi - lo))
    return out


def check_flash_decode(card):
    from elephas_tpu_torch.ops.flash_decode import (
        decode_attention_reference_lse, flash_decode_lse)

    gen = np.random.default_rng(SEED + 1)
    T = 1024
    gpt2_pos = [0, 1023] + [int(p) for p in gen.integers(0, T, size=6)]
    cases = [
        ("gpt2_f32", dict(B=8, hkv=12, g=1, dh=64, T=T), torch.float32, gpt2_pos, None, False, 1e-5),
        ("gqa_f32", dict(B=4, hkv=8, g=4, dh=128, T=T), torch.float32, [0, 511, 700, 1023], None, False, 1e-5),
        ("window_f32", dict(B=8, hkv=12, g=1, dh=64, T=T), torch.float32, gpt2_pos, 128, False, 1e-5),
        ("ring_f32", dict(B=6, hkv=4, g=2, dh=64, T=256), torch.float32, [0, 100, 255, 256, 700, 1023], 200, True, 1e-5),
        ("gpt2_bf16", dict(B=8, hkv=12, g=1, dh=64, T=T), torch.bfloat16, gpt2_pos, None, False, 2e-2),
    ]
    checks, worst = [], 0.0
    for name, shp, dtype, pos, window, ring, tol in cases:
        q, k, v, pos_t = _decode_inputs(gen, shp["B"], shp["hkv"], shp["g"],
                                        shp["dh"], shp["T"], dtype, pos)
        o, lse = flash_decode_lse(q, k, v, pos_t, window=window, ring=ring)
        torch.cuda.synchronize()
        wo, wl = decode_attention_reference_lse(q, k, v, pos_t, window, ring)
        err = max(float((o - wo).abs().max()), float((lse - wl).abs().max()))
        require(err <= tol, f"flash_decode {name}: max abs err {err} > {tol}")
        worst = max(worst, err) if dtype == torch.float32 else worst
        checks.append({"case": name, "shape": shp, "dtype": str(dtype),
                       "pos": pos, "window": window, "ring": ring,
                       "max_abs_err": err, "atol": tol})

    # timing at the GPT-2-small decode shape, float32 cache, per-row pos of
    # the gpt2 case; 8 copies of the cache (400 MB) so reads miss the L2
    B, hkv, g, dh = 8, 12, 1, 64
    sets = [_decode_inputs(gen, B, hkv, g, dh, T, torch.float32, gpt2_pos)
            for _ in range(8)]
    ms = device_ms(lambda q, k, v, p: flash_decode_lse(q, k, v, p), sets)
    plain_ms = device_ms(lambda q, k, v, p: decode_attention_reference_lse(q, k, v, p), sets)
    slots = torch.arange(T, device="cuda")
    masks = [(slots[None, :] <= s[3][:, None].long())[:, None, None, :] for s in sets]
    lib_sets = [s[:3] + (m,) for s, m in zip(sets, masks)]
    lib_ms = device_ms(lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=m), lib_sets)
    vis = sum(_visible(gpt2_pos, T))
    n_bytes = vis * hkv * dh * 2 * 4 + (2 * B * hkv * g * dh + B * hkv * g + B) * 4
    bms, by = bound_ms(n_bytes, vis * hkv * g * dh * 4)
    row = {"name": "flash_decode_lse", "route": "cuda",
           "source": "elephas_tpu_torch/ops/csrc/flash_decode.cu",
           "replaces": "elephas_tpu/ops/flash_decode.py:217",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "timed_shape": {"B": B, "Hkv": hkv, "G": g, "Dh": dh, "T": T,
                           "pos": gpt2_pos, "kv_dtype": "float32"}}
    emit({"phase": "kernel", "kernel": "flash_decode_lse", "checks": checks,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": bms, "bound_by": by, "card": card})
    return row


# -- phases 3 and 4 -------------------------------------------------------------


def serve(card):
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.ops.flash_decode import flash_decode_lse
    from elephas_tpu_torch.ops.layer_norm import fused_layer_norm
    from elephas_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model = TransformerLM(**GPT2_SMALL, device="cuda")
    params = model.init(SEED)
    setup_s = time.perf_counter() - t0
    gen = np.random.default_rng(SEED + 2)
    V = GPT2_SMALL["vocab"]
    prompts = [gen.integers(0, V, size=int(n)).astype(np.int32)
               for n in gen.integers(32, 257, size=16)]
    max_new = 64

    # warm-up (cuBLAS handles, allocator), outside the counted run
    warm = ServingEngine(model, params, n_slots=8, device="cuda")
    for p in prompts[:2]:
        warm.submit(p[:32], 4)
    warm.drain()
    del warm
    torch.cuda.synchronize()

    eng = ServingEngine(model, params, n_slots=8, device="cuda")
    flash_decode_lse.launches = 0
    fused_layer_norm.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new) for p in prompts]
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, k3 = flash_decode_lse.launches, fused_layer_norm.launches

    snap = eng.snapshot()
    steps = snap["engine"]["decode_steps"]
    prefills = snap["engine"]["prefills"]
    L = GPT2_SMALL["n_layers"]
    require(len(fin) == 16, f"{len(fin)} of 16 requests finished")
    for rid in ids:
        r = fin[rid]
        require(r.finish_reason == "length", f"{rid} finished by {r.finish_reason}")
        require(len(r.tokens) == max_new, f"{rid}: {len(r.tokens)} tokens")
        require(all(0 <= t < V for t in r.tokens), f"{rid}: token out of range")
    require(steps > 0 and k4 == L * steps,
            f"flash_decode launches {k4} != {L} x {steps} decode steps")
    require(k3 == (2 * L + 1) * (steps + prefills),
            f"layer_norm launches {k3} != {2 * L + 1} x ({steps} decode steps "
            f"+ {prefills} prefills)")
    n_tok = sum(len(fin[r].tokens) for r in ids)
    ttft = snap["requests"]["ttft_s"]
    itl = snap["fastpath"]["inter_token_latency_s"]
    emit({"phase": "serve", "model": "gpt2-small (random weights, seed 0)",
          "requests": 16, "new_tokens_each": max_new,
          "prompt_lens": [int(len(p)) for p in prompts],
          "decode_steps": steps, "prefills": prefills,
          "launches": {"flash_decode_lse": k4, "layer_norm_fwd": k3},
          "launches_per_decode_step": {"flash_decode_lse": k4 / steps},
          "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
          "ttft_p50_s": ttft["p50"], "ttft_p95_s": ttft["p95"],
          "decode_ms_per_step_p50": itl["p50"] * 1e3,
          "decode_ms_per_step_mean": itl["mean"] * 1e3,
          "batch_occupancy": snap["engine"]["batch_occupancy"],
          "weights_setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    return params, prompts, [fin[r].tokens for r in ids], {
        "flash_decode_lse": k4, "layer_norm_fwd": k3}


def cross_check(card, params, prompts, gpu_tokens):
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    order = np.argsort([len(p) for p in prompts])[:2]   # the two shortest
    n_new = 8
    eng = ServingEngine(model, cpu_params, n_slots=2, device="cpu")
    ids = [eng.submit(prompts[i], n_new) for i in order]
    fin = eng.drain()
    rows = []
    for rid, i in zip(ids, order):
        cpu = fin[rid].tokens
        seq = np.concatenate([prompts[i], np.asarray(cpu[:-1], np.int32)])
        logits, _ = model.decode_chunk(
            cpu_params, torch.from_numpy(seq.astype(np.int64))[None], 0,
            model.init_cache(1, len(seq)))
        top = torch.topk(logits[0, len(prompts[i]) - 1:], 2, dim=-1).values
        gaps = (top[:, 0] - top[:, 1]).tolist()
        n = 0
        while n < n_new and gaps[n] > 1e-3:
            require(cpu[n] == gpu_tokens[i][n],
                    f"request {i}: position {n} gpu {gpu_tokens[i][n]} != "
                    f"cpu {cpu[n]} (gap {gaps[n]})")
            n += 1
        rows.append({"request": int(i), "prompt_len": int(len(prompts[i])),
                     "compared": n, "min_gap": min(gaps), "cpu": cpu,
                     "gpu": gpu_tokens[i][:n_new]})
    emit({"phase": "cross_check", "requests": rows, "card": card})


def profiled(run, n_steps: int, top_n: int = 12):
    """``run()`` ``n_steps`` times under ``torch.profiler``: wall ms and
    device ms per step, the device's busy share of the window (the
    profiler's own host cost inflates the wall time) and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    return {"wall_ms_per_step": wall * 1e3 / n_steps,
            "device_ms_per_step": busy_us / 1e3 / n_steps,
            "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "us_per_step": e.self_device_time_total / n_steps}
                            for e in top]}


def profile_decode(card, params, prompts):
    """Ten decode steps of a full 8-slot batch under ``torch.profiler``
    (the unprofiled step time is the serve phase's)."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    eng = ServingEngine(model, params, n_slots=8, device="cuda")
    for p in prompts[:8]:
        eng.submit(p, 32)
    while eng.kv.free_slots:
        eng.step()

    def run():
        require(eng.step() == "decode", "profile window left the decode loop")

    emit({"phase": "profile", "decode_steps": 10, **profiled(run, 10),
          "card": card})


# -- phases 6 to 8 -----------------------------------------------------------------


def _counters():
    """Every kernel wrapper of the port by its row name."""
    from elephas_tpu_torch.ops.flash_attention import (flash_attention_dkv,
                                                       flash_attention_dq,
                                                       flash_attention_fwd)
    from elephas_tpu_torch.ops.flash_decode import flash_decode_lse
    from elephas_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                  fused_layer_norm_bwd)

    return {"layer_norm_fwd": fused_layer_norm, "layer_norm_bwd": fused_layer_norm_bwd,
            "flash_decode_lse": flash_decode_lse,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_dq": flash_attention_dq,
            "flash_attention_dkv": flash_attention_dkv}


def _zero_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {name: fn.launches for name, fn in _counters().items()}


def train(card, params):
    """GPT-2-small training through the port's step builder: counters set
    to 0 just before the timed steps and read just after."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    B, T = 8, 1024
    rows = np.random.default_rng(SEED + 4).integers(0, GPT2_SMALL["vocab"],
                                                    size=(B, T + 1))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3),
                                         attn="flash")
    state = opt_init(params)
    p = params
    losses = []
    for _ in range(2):                                  # warm-up
        p, state, loss = step(p, state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 5
    _zero_counters()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        p, state, loss = step(p, state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = GPT2_SMALL["n_layers"]
    require(all(np.isfinite(losses)), f"train: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    want = {"flash_attention_fwd": L, "flash_attention_dq": L,
            "flash_attention_dkv": L, "layer_norm_fwd": 2 * L + 1,
            "layer_norm_bwd": 2 * L + 1, "flash_decode_lse": 0}
    for name, per_step in want.items():
        require(counts[name] == per_step * n_steps,
                f"train: {name} launched {counts[name]} times in {n_steps} "
                f"steps, want {per_step} per step")

    # one more step under the profiler: where the device time goes
    prof = profiled(lambda: step(p, state, *batch), 1, top_n=16)

    # the streamed head against the dense head, one step from the same state
    step_vb, _ = build_lm_train_step(model, None, adam_compact(1e-3),
                                     attn="flash", vocab_block=8192)
    loss_vb = float(step_vb(p, state, *batch)[2])
    loss_dense = float(step(p, state, *batch)[2])
    rel = abs(loss_vb - loss_dense) / abs(loss_dense)
    require(rel <= 1e-5, f"train: vocab_block loss {loss_vb} vs dense "
                         f"{loss_dense} (relative {rel} > 1e-5)")
    emit({"phase": "train", "model": "gpt2-small (random weights, seed 0)",
          "dtype": "float32", "optimizer": "adam_compact(1e-3)", "attn": "flash",
          "batch": B, "seq_len": T, "warmup_steps": 2, "timed_steps": n_steps,
          "ms_per_step": wall * 1e3 / n_steps,
          "tokens_per_s": n_steps * B * T / wall,
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "launches": counts,
          "launches_per_step": {k: v / n_steps for k, v in counts.items()},
          "vocab_block_8192": {"loss": loss_vb, "dense_loss": loss_dense,
                               "relative_diff": rel, "rtol": 1e-5},
          "profiled_step": prof, "card": card})
    return counts


def train_cross_check(card, params):
    """One step's loss and gradients at B=1, T=128: the card's kernels
    against the CPU's plain versions. Loss rtol 1e-4; every gradient
    within 1e-3 of its parameter's largest gradient entry (float32 sums in
    another order through 12 layers). That scale is floored at 1e-4 of the
    largest entry over all parameters: the key bias ``bk`` has an exact
    gradient of zero (softmax ignores a shift of all of a query's scores),
    so its entries are rounding noise on both devices."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    rows = np.random.default_rng(SEED + 6).integers(0, GPT2_SMALL["vocab"],
                                                    size=(1, 129))
    batch = make_lm_batches(rows)
    out = {}
    for dev, p in (("cuda", params), ("cpu", {k: v.cpu() for k, v in params.items()})):
        model = TransformerLM(**GPT2_SMALL, device=dev)
        step, _ = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
        loss, grads = step.grad(p, *batch)
        out[dev] = (float(loss), {k: g.cpu().double() for k, g in grads.items()})
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    require(loss_rel <= 1e-4, f"train_cross_check: loss {lg} vs cpu {lc}")
    floor = 1e-4 * max(float(g.abs().max()) for g in gc.values())
    grad_rel, grad_maxabs = {}, {}
    for k in gc:
        grad_maxabs[k] = float(gc[k].abs().max())
        grad_rel[k] = float((gg[k] - gc[k]).abs().max()) / max(grad_maxabs[k], floor)
    worst = max(grad_rel, key=grad_rel.get)
    require(grad_rel[worst] <= 1e-3,
            f"train_cross_check: gradient of {worst} off by {grad_rel[worst]} "
            f"of its scale")
    emit({"phase": "train_cross_check", "batch": 1, "seq_len": 128,
          "loss_gpu": lg, "loss_cpu": lc, "loss_rel_diff": loss_rel,
          "loss_rtol": 1e-4, "grad_err_rel_to_scale": grad_rel,
          "grad_maxabs_cpu": grad_maxabs, "scale_floor": floor,
          "grad_tol": 1e-3, "card": card})


def generate_phase(card, params):
    """Greedy ``generate`` on the card: its launch counts, then its tokens
    against the serving engine's on the same prompts."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    V, L = GPT2_SMALL["vocab"], GPT2_SMALL["n_layers"]
    rows, t0_len, n_new = 4, 128, 32
    prompts = np.random.default_rng(SEED + 7).integers(0, V, size=(rows, t0_len))
    prompt = torch.from_numpy(prompts).cuda()
    model.generate(params, prompt[:, :16], 2)           # warm-up
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    out = model.generate(params, prompt, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    decode_steps = n_new - 1
    require(tuple(out.shape) == (rows, t0_len + n_new), f"generate: shape {tuple(out.shape)}")
    require(bool(((out >= 0) & (out < V)).all()), "generate: token out of range")
    require(counts["flash_attention_fwd"] == L,
            f"generate: {counts['flash_attention_fwd']} flash-attention launches, "
            f"want {L} (one prefill)")
    require(counts["flash_decode_lse"] == L * decode_steps,
            f"generate: {counts['flash_decode_lse']} flash-decode launches, want "
            f"{L} x {decode_steps} decode steps")
    require(counts["layer_norm_fwd"] == (2 * L + 1) * (1 + decode_steps),
            f"generate: {counts['layer_norm_fwd']} layer-norm launches")
    require(counts["layer_norm_bwd"] + counts["flash_attention_dq"]
            + counts["flash_attention_dkv"] == 0, "generate: a backward kernel ran")

    eng = ServingEngine(model, params, n_slots=rows, device="cuda")
    ids = [eng.submit(p.astype(np.int32), n_new) for p in prompts]
    fin = eng.drain()
    gen = out[:, t0_len:].cpu()
    with torch.no_grad():
        pos = torch.arange(t0_len + n_new - 1, device=out.device).expand(rows, -1)
        logits = model.apply(params, out[:, :-1], pos, attn="flash")
        top = torch.topk(logits[:, t0_len - 1:], 2, dim=-1).values.cpu()
    gaps = (top[..., 0] - top[..., 1])
    compared = []
    for r, rid in enumerate(ids):
        eng_tokens = fin[rid].tokens
        n = 0
        while n < n_new and float(gaps[r, n]) > 1e-3:
            require(int(gen[r, n]) == eng_tokens[n],
                    f"generate: row {r} position {n}: generate {int(gen[r, n])} "
                    f"!= engine {eng_tokens[n]} (gap {float(gaps[r, n])})")
            n += 1
        compared.append(n)
    emit({"phase": "generate", "rows": rows, "prompt_len": t0_len, "n_new": n_new,
          "wall_s": wall, "tok_per_s": rows * n_new / wall,
          "launches": counts, "tokens_compared_with_engine": compared,
          "min_gap": float(gaps.min()), "card": card})
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU and has nothing to run here",
              file=sys.stderr)
        return 2
    try:
        from elephas_tpu_torch import resolve_device
        from elephas_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    resolve_device("cuda")          # also pins float32 matmuls to full precision
    raw, name, limit = card_line()
    print(raw, flush=True)
    card = {"name": name, "power_limit": limit}
    emit({"phase": "card", **card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    built = _build.build(["layer_norm", "flash_decode", "flash_attention"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "card": card})
    try:
        ln_fwd, ln_bwd = check_layer_norm(card), check_layer_norm_bwd(card)
        decode = check_flash_decode(card)
        attn_rows = check_flash_attention(card)
        params, prompts, gpu_tokens, serve_counts = serve(card)
        cross_check(card, params, prompts, gpu_tokens)
        profile_decode(card, params, prompts)
        train_counts = train(card, params)
        train_cross_check(card, params)
        gen_counts = generate_phase(card, params)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # each row's `launches` is its own slice's main path: serving for
    # K3-fwd and K4, the five timed train steps for the rest
    rows = [ln_fwd, ln_bwd, decode, *attn_rows]
    for row in rows:
        name = row["name"]
        row["launches"] = (serve_counts if name in serve_counts else train_counts)[name]
        row["launches_by_path"] = {"serve": serve_counts.get(name, 0),
                                   "train_5_steps": train_counts[name],
                                   "generate": gen_counts[name]}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
