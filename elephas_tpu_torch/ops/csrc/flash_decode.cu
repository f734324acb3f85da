// Split-K flash decoding over a dense cache for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: elephas_tpu/ops/flash_decode.py `flash_decode_lse` (the Pallas
// `_decode_kernel_lse`): grouped decode attention of one query position per
// row against a dense cache. q [B, Hkv, G, Dh] float32, k/v [B, Hkv, T, Dh]
// float32 or bfloat16, pos [B] int32 -> out [B, Hkv, G, Dh] float32 and
// lse [B, Hkv, G] float32 (log of the softmax denominator). Row b sees
// cache slots 0..pos[b], cut to the last `window` of them under a sliding
// window; a ring cache masks by slot age (pos - j) mod T < min(window,
// pos + 1), exactly as decode_attention_reference_lse does.
//
// Bound on an H100: bytes. A decode step reads every visible K/V row once,
// 2 * Dh * sizeof(kv) bytes per slot and KV head, and does 4 * G * Dh
// operations on it: at G <= 8 that is at most 4 float32 operations per
// byte, far below the ~20 at which the 67 TFLOP/s float32 rate would bind.
// GPT-2-small decode with 8 rows and a full 1024-slot float32 cache reads
// ~50 MB per launch, ~15 us at 3.35 TB/s.
//
// Design: the paged decode's (decode_split.cuh), on the dense cache read
// as a pool of B pages of T rows with no table (DenseRows): the split
// count follows the grid, each block cuts its piece of the visible range
// from pos on the device, the piece's 32-row tiles pass through a
// two-stage cp.async ring, each warp keeps its own online softmax, and the
// combine is one warp a row, launched as a programmatic dependent. A ring
// cache's visible range is the logical positions [pos - n + 1, pos], n =
// min(window, pos + 1, T), position j in slot j mod T, so its pieces, and a
// tile, may wrap round the cache.

#include "decode_split.cuh"

namespace {

// Dh <= 64 and <= 128 pick the tile class; the wrapper refuses Dh > 128.
template <typename E>
int decode_any(const KV& kv, const Decode& P, cudaStream_t st) {
  if (kv.Dh <= 64) return decode_g<E, 64>(kv, DenseRows{}, P, st);
  return decode_g<E, 128>(kv, DenseRows{}, P, st);
}

}  // namespace

extern "C" int flash_decode_lse(const float* q, const void* k, const void* v,
                                const int* pos, float* o_part, float* m_part,
                                float* l_part, float* out, float* lse, int B, int Hkv,
                                int G, int Dh, int T, int window, int ring, int n_split,
                                int align, float scale, int kv_bf16, void* stream) {
  const KV kv{k, v, Hkv, T, Dh};
  const Decode D{q, pos, o_part, m_part, l_part, out, lse, B, G, window, ring, T, n_split,
                 align, 1, scale};
  if (B == 0 || Hkv == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || n_split < 1 || align < 1 || (ring && window < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? decode_any<__nv_bfloat16>(kv, D, st) : decode_any<float>(kv, D, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
