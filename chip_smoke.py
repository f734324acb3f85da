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
   67 TFLOP/s float32, whichever is larger; H100 SXM data-sheet peaks).
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


def profile_decode(card, params, prompts):
    """Ten decode steps of a full 8-slot batch under ``torch.profiler``:
    device time by kernel, and the device's busy share of the window (the
    profiler's own host cost inflates the wall time, so the unprofiled
    step time is the serve phase's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    eng = ServingEngine(model, params, n_slots=8, device="cuda")
    for p in prompts[:8]:
        eng.submit(p, 32)
    while eng.kv.free_slots:
        eng.step()
    torch.cuda.synchronize()
    n_steps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            require(eng.step() == "decode", "profile window left the decode loop")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "profile", "decode_steps": n_steps,
          "wall_ms_per_step": wall * 1e3 / n_steps,
          "device_ms_per_step": busy_us / 1e3 / n_steps,
          "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
          "top_kernels": [{"name": e.key[:90], "count": e.count,
                           "us_per_step": e.self_device_time_total / n_steps}
                          for e in top],
          "card": card})


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
    built = _build.build(["layer_norm", "flash_decode"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "card": card})
    try:
        rows = [check_layer_norm(card), check_flash_decode(card)]
        params, prompts, gpu_tokens, launches = serve(card)
        cross_check(card, params, prompts, gpu_tokens)
        profile_decode(card, params, prompts)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
