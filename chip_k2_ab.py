#!/usr/bin/env python3
"""Time the flash-attention kernels (K2-fwd, K2-dq, K2-dkv) built from two
sources of ``flash_attention.cu`` in turns on one NVIDIA GPU: this tree's
and another one (for example a parent commit's), in the order other,
tree, tree, other, at the GPT-2 training shape (B 8, H 12, T 1024, Dh 64,
causal, float32) and the Llama-3-8B rope shape (B 4, H 32, Hkv 8, T 2048,
Dh 128, causal, float32, rope on load), beside the yardsticks that
``chip_smoke.py`` times: SDPA forward and autograd backward, and
rotate-then-SDPA. At the Llama shape each turn also times the plain K2-fwd
on q and k rotated beforehand (``llama_fwd``) and ``_rope_rotate`` then the
plain K2-fwd (``llama_rotate_then_fwd``); the yardsticks there are SDPA's
forward with ``enable_gqa`` on the rotated q and k (``llama_sdpa_fwd``) and
rotate-then-SDPA's forward (``llama_rotate_sdpa_fwd``). Uses
``chip_smoke.py``'s inputs and ``device_ms``.

Run from the repository root::

    git archive <commit> elephas_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 chip_k2_ab.py <dir>/elephas_tpu_torch/ops/csrc/flash_attention.cu

(the whole ``csrc`` directory: the source includes its headers from there).

Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
turn and one for the yardsticks. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def _build(src: Path, out: Path) -> ctypes.CDLL:
    from elephas_tpu_torch.ops import _build as build

    fa = importlib.import_module("elephas_tpu_torch.ops.flash_attention")
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in fa._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from elephas_tpu_torch import resolve_device
    from elephas_tpu_torch.models.transformer import _rope_rotate
    from elephas_tpu_torch.ops import _build as build

    fa = importlib.import_module("elephas_tpu_torch.ops.flash_attention")
    resolve_device("cuda")
    print(cs.card_line()[0], flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = {"other": Path(sys.argv[1]), "tree": build.CSRC / "flash_attention.cu"}
    with ThreadPoolExecutor(2) as ex:
        libs = dict(zip(srcs, ex.map(
            lambda kv: _build(kv[1], build.BUILD_DIR / f"ab_{kv[0]}.so"), srcs.items())))

    gen = np.random.default_rng(0)
    g_sets, l_sets = [], []
    for _ in range(2):
        q, k, v, do = cs._attn_inputs(gen, 8, 12, 12, 1024, 64, torch.float32)
        o, lse = fa.attention_fwd_reference(q, k, v, True)
        g_sets.append((q, k, v, do, lse, (do * o).sum(-1).transpose(1, 2).contiguous()))
    r_sets = []
    for _ in range(2):
        q, k, v, do = cs._attn_inputs(gen, 4, 32, 8, 2048, 128, torch.float32)
        c2, s2 = cs._rope_tables(4, 2048, 128)
        o, lse = fa.rope_attention_fwd_reference(q, k, v, c2, s2, True)
        l_sets.append((q, k, v, do, lse, (do * o).sum(-1).transpose(1, 2).contiguous(), c2, s2))
        cos, sin = c2[:, :, None, :64], s2[:, :, None, 64:]
        r_sets.append((q, k, v, cos, sin, _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin)))
        del o
    for turn in ("other", "tree", "tree", "other"):
        build._loaded["flash_attention"] = libs[turn]
        print(json.dumps({
            "kernels": turn, "source": str(srcs[turn]),
            "gpt2_fwd": cs.device_ms(lambda q, k, v, *_: fa.flash_attention_fwd(q, k, v, True),
                                     g_sets, 20),
            "gpt2_dq": cs.device_ms(lambda *a: fa.flash_attention_dq(*a, True), g_sets, 20),
            "gpt2_dkv": cs.device_ms(lambda *a: fa.flash_attention_dkv(*a, True), g_sets, 20),
            "llama_rope_fwd": cs.device_ms(
                lambda q, k, v, do, lse, delta, c2, s2:
                fa.flash_attention_rope_fwd(q, k, v, c2, s2, True), l_sets, 6),
            "llama_rope_dq": cs.device_ms(lambda *a: fa.flash_attention_rope_dq(*a, True),
                                          l_sets, 6),
            "llama_rope_dkv": cs.device_ms(lambda *a: fa.flash_attention_rope_dkv(*a, True),
                                           l_sets, 6),
            "llama_fwd": cs.device_ms(lambda q, k, v, cos, sin, qr, kr:
                                      fa.flash_attention_fwd(qr, kr, v, True), r_sets, 6),
            "llama_rotate_then_fwd": cs.device_ms(
                lambda q, k, v, cos, sin, qr, kr: fa.flash_attention_fwd(
                    _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin), v, True),
                r_sets, 6)}), flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s[:4]) for s in g_sets]
    out = {"gpt2_sdpa_fwd": cs.device_ms(lambda q, k, v, _: sdpa(q, k, v, is_causal=True),
                                         lib_sets, 20)}
    graphs = []
    for q, k, v, do in lib_sets:
        args = [t.detach().requires_grad_() for t in (q, k, v)]
        graphs.append((sdpa(*args, is_causal=True), args, do))
    out["gpt2_sdpa_bwd"] = cs.device_ms(lambda o, args, do: torch.autograd.grad(
        o, args, do, retain_graph=True), graphs, 20)
    del graphs, lib_sets
    out["llama_sdpa_fwd"] = cs.device_ms(
        lambda q, k, v, cos, sin, qr, kr: sdpa(
            qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True), r_sets, 6)
    out["llama_rotate_sdpa_fwd"] = cs.device_ms(
        lambda q, k, v, cos, sin, qr, kr: sdpa(
            _rope_rotate(q, cos, sin).transpose(1, 2), _rope_rotate(k, cos, sin).transpose(1, 2),
            v.transpose(1, 2), is_causal=True, enable_gqa=True), r_sets, 6)
    del r_sets
    graphs = []
    for q, k, v, do, _, _, c2, s2 in l_sets:
        cos, sin = c2[:, :, None, :64], s2[:, :, None, 64:]
        args = [t.detach().requires_grad_() for t in (q, k, v)]
        o = sdpa(_rope_rotate(args[0], cos, sin).transpose(1, 2),
                 _rope_rotate(args[1], cos, sin).transpose(1, 2), args[2].transpose(1, 2),
                 is_causal=True, enable_gqa=True).transpose(1, 2)
        graphs.append((o, args, do))
    out["llama_rotate_sdpa_bwd"] = cs.device_ms(lambda o, args, do: torch.autograd.grad(
        o, args, do, retain_graph=True), graphs, 6)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
