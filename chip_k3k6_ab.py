#!/usr/bin/env python3
"""Time K3-fwd and K3-bwd (the LayerNorm forward and backward), K5-decode
(paged decode attention), K6-gmm (``gmm`` and ``gmm_t``) and K6-tgmm built
from two sources of ``layer_norm.cu``, ``paged_attention.cu`` and
``grouped_matmul.cu`` in turns on one NVIDIA GPU: this tree's and another
one (for example a parent commit's), in the order other, tree, tree,
other, beside the yardsticks that ``chip_smoke.py`` times.

- K3-fwd at GPT-2's training shape ``[8192, 768]`` and its decode shape
  ``[8, 768]`` (four input sets), beside ``F.layer_norm``.
- K3-bwd at GPT-2's training shape ``[8192, 768]`` (float32; four input sets
  of 50 MB each keep the reads out of the 50 MB L2), beside the autograd
  backward of ``F.layer_norm``; and at ``[8192, 1024]`` and ``[8192,
  1025]``, the two sides of the register route's width limit.
- K5-decode at GPT-2's paged serving shape (8 slots, 12 KV heads, Dh 64,
  pages of 16, 64 pages a slot, a float32 pool) at three position sets:
  ``chip_smoke.py``'s (15-1023), the serve mix's (32-320) and a full cache
  (all at 1023); eight pools of 50 MB each, beside SDPA over the equivalent
  dense cache with an explicit mask. The split count and the argument
  that follows it are each source's own: a split length of whole 64-row
  tiles from the cache length before the redesign, the alignment unit of
  the pieces cut by ``pos`` after it.
- K6-gmm at the Mixtral-8x7B widths of ``chip_smoke.py``'s ``kernel``
  phase: ``decode_w1`` (``gmm``, 8 routed tokens in 1152 rows, K 4096, N
  14336) and ``train_w1`` (9216 rows: ``gmm`` of the tokens by w1 and
  ``gmm_t`` of a ``[9216, 14336]`` cotangent by w1), float32, and
  ``decode_w1`` in bf16, beside the per-expert ``torch.matmul`` loop and
  the card's ``mma.sync`` ceiling: TF32 ``m16n8k8`` and bf16 ``m16n8k16``
  issued back to back from registers (8 warps an SM, 8 independent
  accumulators a warp, no memory traffic), the rate K6-gmm's products can
  reach at most (a float32 product is three TF32 ones).
- K6-tgmm at the same widths: ``train_w1`` (the ``[9216, 4096]`` tokens
  against a ``[9216, 14336]`` cotangent: dw1's product) and ``train_w2``
  (the ``[9216, 14336]`` activations against a ``[9216, 4096]`` cotangent:
  dw2's) in float32, and ``decode_w1_bf16`` and ``train_w1_bf16`` (the same
  rows in bf16, a float32 output), each run twice for the same bits, beside
  the per-tile ``torch.bmm`` + per-expert sum and, in bf16,
  ``torch._grouped_mm`` over the contraction (``mat_a = lhs.T``, ``offs``
  the experts' row ends).

Each source is called through its own C interface (the argument lists
changed when the kernels were redesigned), read from its text. Every turn
also checks the kernels against the plain versions (``max |diff| / max
|plain|``; K5-decode's ``max |diff|`` of out and lse) and runs each twice
for the same bits, so a faster source that is wrong shows.

Run from the repository root::

    git archive <commit> elephas_tpu_torch/ops/csrc | tar -x -C <dir>
    python3 chip_k3k6_ab.py <dir>/elephas_tpu_torch/ops/csrc

Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
turn and one for the yardsticks. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each C entry point's argument types, before and after the redesign:
# layer_norm_fwd and layer_norm_bwd gained (route, vec), gmm gained (vec);
# paged_decode_lse kept its types (its chunk length became an alignment)
LN_FWD = {False: [P] * 4 + [I] * 2 + [F, P], True: [P] * 4 + [I] * 4 + [F, P]}
LN_BWD = {False: [P] * 8 + [I] * 4 + [F, P], True: [P] * 8 + [I] * 6 + [F, P]}
PAGED_DECODE = [P] * 10 + [I] * 10 + [F, I, P]
GPT2_POS = [31, 15, 16, 511, 512, 700, 1000, 1023]
SERVE_POS = [32, 64, 100, 150, 200, 256, 288, 320]
GMM = {False: [P] * 4 + [I] * 7 + [P], True: [P] * 4 + [I] * 8 + [P]}
TGMM = [P] * 4 + [I] * 7 + [P]   # unchanged by the redesign


def build(src: Path, out: Path, fn: str, argtypes) -> ctypes.CDLL:
    from elephas_tpu_torch.ops import _build

    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def new_abi(src: Path, fn: str, marker: str) -> bool:
    """Whether the C entry ``fn`` of ``src`` names ``marker`` among its
    parameters."""
    text = src.read_text()
    at = text.index(f'extern "C" int {fn}(')
    return marker in text[at:text.index(")", at)]


def old_decode_splits(S: int, Hkv: int, T: int, n_sm: int):
    """``(n_split, chunk)`` of K5-decode before the split-by-``pos``
    redesign: about four blocks an SM, each split a whole number of 64-row
    tiles of the cache length T."""
    n_tiles = -(-T // 64)
    want = max(1, -(-4 * n_sm // max(S * Hkv, 1)))
    chunk = -(-n_tiles // min(n_tiles, want)) * 64
    return -(-T // chunk), chunk


class Kernels:
    """One source's K3, K5-decode and K6, called through its C interface."""

    def __init__(self, csrc: Path, tag: str, out_dir: Path):
        ln, gm = csrc / "layer_norm.cu", csrc / "grouped_matmul.cu"
        pa = csrc / "paged_attention.cu"
        self.ln_new = new_abi(ln, "layer_norm_bwd", "int route, int vec")
        self.ln_fwd_new = new_abi(ln, "layer_norm_fwd", "int route, int vec")
        self.gmm_new = new_abi(gm, "gmm", "int bf16, int vec")
        self.pa_new = new_abi(pa, "paged_decode_lse", "int align")
        self.sources = {"layer_norm": str(ln), "grouped_matmul": str(gm),
                        "paged_attention": str(pa)}
        with ThreadPoolExecutor(3) as ex:
            self.ln, self.gm, self.pa = ex.map(lambda a: build(*a), [
                (ln, out_dir / f"ab_ln_{tag}.so", "layer_norm_bwd", LN_BWD[self.ln_new]),
                (gm, out_dir / f"ab_gmm_{tag}.so", "gmm", GMM[self.gmm_new]),
                (pa, out_dir / f"ab_pa_{tag}.so", "paged_decode_lse", PAGED_DECODE)])
        self.gm.tgmm.argtypes = TGMM
        self.gm.tgmm.restype = ctypes.c_int
        self.ln.layer_norm_fwd.argtypes = LN_FWD[self.ln_fwd_new]
        self.ln.layer_norm_fwd.restype = ctypes.c_int

    def ln_fwd(self, x, s, b, eps=1e-5):
        N, D = x.shape
        out = torch.empty_like(x)
        ints = [N, D] + ([0 if D <= 1024 else 1, int(D % 4 == 0)] if self.ln_fwd_new else [])
        err = self.ln.layer_norm_fwd(x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     *ints, eps, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"layer_norm_fwd: CUDA error {err}")
        return out

    def paged_decode(self, q, kp, vp, table, pos, page=16):
        """K5-decode's ``(out, lse)``, no window, with this source's split
        rule."""
        from elephas_tpu_torch.ops.paged_attention import _ALIGN, _splits

        S, Hkv, G, Dh = q.shape
        M = table.shape[1]
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        if self.pa_new:
            n_split, arg = _splits(S, Hkv, M * page, n_sm), min(_ALIGN, page)
        else:
            n_split, arg = old_decode_splits(S, Hkv, M * page, n_sm)
        f32 = dict(dtype=torch.float32, device=q.device)
        o_part = torch.empty((S, Hkv, n_split, G, Dh), **f32)
        ml = torch.empty((2, S, Hkv, n_split, G), **f32)
        out = torch.empty((S, Hkv, G, Dh), **f32)
        lse = torch.empty((S, Hkv, G), **f32)
        err = self.pa.paged_decode_lse(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), pos.data_ptr(),
            o_part.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr(), out.data_ptr(),
            lse.data_ptr(), S, Hkv, G, Dh, kp.shape[0], page, M, -1, n_split, arg,
            Dh ** -0.5, int(kp.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"paged_decode_lse: CUDA error {err}")
        return out, lse

    def ln_bwd(self, x, s, g, eps=1e-5):
        from elephas_tpu_torch.ops.layer_norm import _ROW_MAX_D, _bwd_grid

        N, D = x.shape
        if self.ln_new:
            n_blocks, rows = _bwd_grid(N)
        else:                      # the parent's grid: at most 512 blocks
            rows = -(-N // 512)
            n_blocks = -(-N // rows)
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        parts = torch.empty((2, n_blocks, D), **f32)
        ds, db = torch.empty((D,), **f32), torch.empty((D,), **f32)
        ptrs = [t.data_ptr() for t in (x, s, g, dx, parts[0], parts[1], ds, db)]
        ints = [N, D, n_blocks, rows]
        if self.ln_new:
            ints += [0 if D <= _ROW_MAX_D else 1, int(D % 4 == 0)]
        err = self.ln.layer_norm_bwd(*ptrs, *ints, eps,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"layer_norm_bwd: CUDA error {err}")
        return dx, ds, db

    def gmm(self, lhs, rhs, gmap, transpose=False):
        M, K = lhs.shape
        E = rhs.shape[0]
        N = rhs.shape[1] if transpose else rhs.shape[2]
        out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
        ints = [M, K, N, E, M // gmap.numel(), int(transpose),
                int(lhs.dtype == torch.bfloat16)]
        if self.gmm_new:
            ints.append(int(K % (16 // lhs.element_size()) == 0
                            and N % (16 // lhs.element_size()) == 0))
        err = self.gm.gmm(lhs.data_ptr(), rhs.data_ptr(), gmap.data_ptr(), out.data_ptr(),
                          *ints, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gmm: CUDA error {err}")
        return out

    def tgmm(self, lhs, g, gmap, E):
        """``[E, K, N]`` float32 from lhs ``[M, K]`` and g ``[M, N]``."""
        K, N = lhs.shape[1], g.shape[1]
        out = torch.empty((E, K, N), dtype=torch.float32, device=lhs.device)
        err = self.gm.tgmm(lhs.data_ptr(), g.data_ptr(), gmap.data_ptr(), out.data_ptr(), K, N,
                           gmap.numel(), lhs.shape[0] // gmap.numel(), E,
                           int(lhs.dtype == torch.bfloat16), 0,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tgmm: CUDA error {err}")
        return out


MMA_PEAK_CU = r"""
#include <cstdint>
template <bool BF16>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, threadIdx.x};
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(float* out, int blocks, int iters, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) mma_loop<true><<<blocks, 256, 0, st>>>(out, iters);
  else mma_loop<false><<<blocks, 256, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_peak_tflops(out_dir: Path):
    """The card's ``mma.sync`` rate, TF32 and bf16, in TFLOP/s: one block
    of 8 warps per SM, each warp 8 independent accumulators, timed with CUDA
    events over 20000 rounds."""
    src = out_dir / "ab_mma_peak.cu"
    src.write_text(MMA_PEAK_CU)
    lib = build(src, out_dir / "ab_mma_peak.so", "mma_peak", [P, I, I, I, P])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    rates = {}
    for name, bf16, flop in (("tf32", 0, 2 * 16 * 8 * 8), ("bf16", 1, 2 * 16 * 8 * 16)):
        stream = torch.cuda.current_stream().cuda_stream
        lib.mma_peak(out.data_ptr(), sms, 100, bf16, stream)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.mma_peak(out.data_ptr(), sms, 20000, bf16, stream)
        end.record()
        end.synchronize()
        if err:
            raise RuntimeError(f"mma_peak: CUDA error {err}")
        rates[f"mma_sync_{name}_tflops"] = (sms * 8 * 8 * 20000 * flop
                                            / start.elapsed_time(end) / 1e9)
    return rates


def rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def ln_inputs(gen, n, d):
    x = (gen.normal(size=(n, d)) * 3 + 1).astype(np.float32)
    s = (1 + 0.1 * gen.normal(size=(d,))).astype(np.float32)
    g = gen.normal(size=(n, d)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (x, s, g))


def gmm_inputs():
    """The ``kernel`` phase's decode and training layouts (a real routing
    through a random Mixtral router), a glorot-uniform w1, and the
    cotangents of tgmm's cases: ``[1152, 14336]`` at the decode layout,
    ``[9216, 14336]`` (h, also w2's activations) and ``[9216, 4096]`` (dout)
    at the training layout."""
    from elephas_tpu_torch.parallel.expert import _gather_rows

    cfg = cs.MIXTRAL_8X7B
    D, Fd, E = cfg["d_model"], cfg["d_ff"], cfg["n_experts"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 30)
    limit = (6.0 / (D + Fd)) ** 0.5
    w1 = (torch.rand((E, D, Fd), device="cuda", generator=gen) * 2 - 1).mul_(limit)
    x, tok, gmap_d = cs._moe_layout(8, gen)
    lhs_d = _gather_rows(x, tok)
    x, tok, gmap_t = cs._moe_layout(4096, gen)
    xs = _gather_rows(x, tok)
    h = torch.randn(xs.shape[0], Fd, device="cuda", generator=gen)
    g_d = torch.randn(lhs_d.shape[0], Fd, device="cuda", generator=gen)
    dout = torch.randn(xs.shape[0], D, device="cuda", generator=gen)
    return w1, (lhs_d, g_d, gmap_d), (xs, h, dout, gmap_t)


def loop_ms(lhs, w, gmap, transpose, n_iter):
    """The per-expert ``torch.matmul`` loop over each expert's rows."""
    tm = lhs.shape[0] // gmap.numel()
    runs = cs._runs(gmap, tm)
    out = torch.empty(lhs.shape[0], w.shape[1] if transpose else w.shape[2],
                      dtype=lhs.dtype, device="cuda")

    def run():
        for e, a, b in runs:
            torch.matmul(lhs[a:b], w[e].T if transpose else w[e], out=out[a:b])
    return cs.device_ms(run, [()], n_iter)


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from elephas_tpu_torch import resolve_device
    from elephas_tpu_torch.ops import _build
    from elephas_tpu_torch.ops import grouped_matmul as G
    from elephas_tpu_torch.ops.layer_norm import layer_norm_reference
    from elephas_tpu_torch.ops.paged_attention import paged_decode_reference_lse

    resolve_device("cuda")
    print(cs.card_line()[0], flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dirs = {"other": Path(sys.argv[1]), "tree": _build.CSRC}
    with ThreadPoolExecutor(2) as ex:
        kern = dict(zip(dirs, ex.map(lambda kv: Kernels(kv[1], kv[0], _build.BUILD_DIR),
                                     dirs.items())))

    gen = np.random.default_rng(0)
    fwd_sets = {n: [ln_inputs(gen, n, 768)[:2]
                    + (torch.from_numpy(gen.normal(size=(768,)).astype(np.float32)).cuda(),)
                    for _ in range(4)] for n in (8192, 8)}
    fwd_want = {n: layer_norm_reference(*sets[0]) for n, sets in fwd_sets.items()}
    pa_sets = {name: [cs._paged_inputs(gen, 8, 12, 1, 64, 16, 64, torch.float32, pos)
                      for _ in range(8)]
               for name, pos in (("gpt2_pos", GPT2_POS), ("serve_pos", SERVE_POS),
                                 ("full_cache", [1023] * 8))}
    pa_want = {name: paged_decode_reference_lse(*sets[0], 16) for name, sets in pa_sets.items()}
    ln_sets = {d: [ln_inputs(gen, 8192, d) for _ in range(4 if d == 768 else 2)]
               for d in (768, 1024, 1025)}
    ln_want = {}
    for d, sets in ln_sets.items():
        x, s, g = sets[0]
        args = [x.clone().requires_grad_(), s.clone().requires_grad_(),
                torch.zeros_like(s).requires_grad_()]
        ln_want[d] = torch.autograd.grad(layer_norm_reference(*args), args, g)
    w1, (lhs_d, g_d, gmap_d), (xs, h, dout, gmap_t) = gmm_inputs()
    bf = torch.bfloat16
    w1b, lhs_db = w1.to(bf), lhs_d.to(bf)
    want = {"decode_w1_gmm": G.gmm_reference(lhs_d, w1, gmap_d),
            "decode_w1_gmm_bf16": G.gmm_reference(lhs_db, w1b, gmap_d)}
    E = w1.shape[0]
    tg_cases = {"train_w1": (xs, h, gmap_t), "train_w2": (h, dout, gmap_t),
                "decode_w1_bf16": (lhs_db, g_d.to(bf), gmap_d),
                "train_w1_bf16": (xs.to(bf), h.to(bf), gmap_t)}
    tg_want = {n: G.tgmm_reference(*c, E) for n, c in tg_cases.items()}
    torch.cuda.synchronize()

    for turn in ("other", "tree", "tree", "other"):
        k = kern[turn]
        row = {"kernels": turn, "sources": k.sources}
        for n, sets in fwd_sets.items():
            got = k.ln_fwd(*sets[0])
            row[f"ln_fwd_{n}x768_err"] = rel(got, fwd_want[n])
            row[f"ln_fwd_{n}x768_same_bits"] = torch.equal(got, k.ln_fwd(*sets[0]))
            row[f"ln_fwd_{n}x768_ms"] = cs.device_ms(k.ln_fwd, sets, 60)
        for name, sets in pa_sets.items():
            got = k.paged_decode(*sets[0])
            row[f"paged_decode_{name}_err"] = max(
                float((a - w).abs().max()) for a, w in zip(got, pa_want[name]))
            row[f"paged_decode_{name}_same_bits"] = all(
                torch.equal(a, b) for a, b in zip(got, k.paged_decode(*sets[0])))
            row[f"paged_decode_{name}_ms"] = cs.device_ms(k.paged_decode, sets, 60)
        for d, sets in ln_sets.items():
            got = k.ln_bwd(*sets[0])
            row[f"ln_bwd_{d}_err"] = max(rel(a, w) for a, w in zip(got, ln_want[d]))
            row[f"ln_bwd_{d}_same_bits"] = all(
                torch.equal(a, b) for a, b in zip(got, k.ln_bwd(*sets[0])))
            row[f"ln_bwd_{d}_ms"] = cs.device_ms(k.ln_bwd, sets, 40)
        got = k.gmm(lhs_d, w1, gmap_d)
        row["decode_w1_gmm_err"] = rel(got, want["decode_w1_gmm"])
        row["decode_w1_gmm_ms"] = cs.device_ms(lambda: k.gmm(lhs_d, w1, gmap_d), [()], 10)
        got = k.gmm(lhs_db, w1b, gmap_d)
        row["decode_w1_gmm_bf16_err"] = rel(got, want["decode_w1_gmm_bf16"])
        row["decode_w1_gmm_bf16_ms"] = cs.device_ms(lambda: k.gmm(lhs_db, w1b, gmap_d),
                                                    [()], 10)
        row["train_w1_gmm_ms"] = cs.device_ms(lambda: k.gmm(xs, w1, gmap_t), [()], 4)
        got = k.gmm(h, w1, gmap_t, True)
        row["train_w1_gmm_t_err"] = rel(got, G.gmm_reference(h, w1, gmap_t, True))
        del got
        row["train_w1_gmm_t_ms"] = cs.device_ms(lambda: k.gmm(h, w1, gmap_t, True), [()], 4)
        for name, (a, b, gmap) in tg_cases.items():
            got = k.tgmm(a, b, gmap, E)
            row[f"{name}_tgmm_err"] = rel(got, tg_want[name])
            row[f"{name}_tgmm_same_bits"] = torch.equal(got, k.tgmm(a, b, gmap, E))
            del got
            row[f"{name}_tgmm_ms"] = cs.device_ms(lambda: k.tgmm(a, b, gmap, E), [()],
                                                  10 if name.startswith("decode") else 4)
        print(json.dumps(row), flush=True)

    out = {}
    for n, sets in fwd_sets.items():
        out[f"F.layer_norm_fwd_{n}x768_ms"] = cs.device_ms(
            lambda x, s, b: torch.nn.functional.layer_norm(x, (768,), s, b, 1e-5), sets, 60)
    slots = torch.arange(1024, device="cuda")
    for name, sets in pa_sets.items():
        lib_sets = []
        for q, kp, vp, t, p in sets:
            kd, vd = cs._dense_view(kp, vp, t, 16)
            lib_sets.append((q, kd, vd, (slots[None, :] <= p[:, None].long())[:, None, None, :]))
        out[f"sdpa_paged_decode_{name}_ms"] = cs.device_ms(
            lambda q, k_, v, m: torch.nn.functional.scaled_dot_product_attention(
                q, k_, v, attn_mask=m), lib_sets, 60)
        del lib_sets
    del pa_sets, pa_want
    for d, sets in ln_sets.items():
        graphs = []
        for x, s, g in sets:
            args = [t.detach().clone().requires_grad_() for t in (x, s, torch.zeros_like(s))]
            graphs.append((torch.nn.functional.layer_norm(args[0], (d,), args[1], args[2],
                                                          1e-5), args, g))
        out[f"F.layer_norm_bwd_{d}_ms"] = cs.device_ms(lambda o, a, g: torch.autograd.grad(
            o, a, g, retain_graph=True), graphs, 40)
        del graphs
    out["decode_w1_loop_ms"] = loop_ms(lhs_d, w1, gmap_d, False, 10)
    out["train_w1_gmm_loop_ms"] = loop_ms(xs, w1, gmap_t, False, 4)
    out["train_w1_gmm_t_loop_ms"] = loop_ms(h, w1, gmap_t, True, 4)
    del tg_want
    for name, (a, b, gmap) in tg_cases.items():
        out[f"{name}_tgmm_bmm_ms"] = cs.device_ms(cs._tgmm_bmm(a, b, gmap), [()], 4)
        if name.endswith("bf16"):
            out[f"{name}_tgmm_grouped_mm_ms"], out[f"{name}_tgmm_grouped_mm_note"] = (
                cs._tgmm_grouped_mm(a, b, gmap, E))
    out.update(mma_peak_tflops(_build.BUILD_DIR))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
