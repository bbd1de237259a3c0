// Dense flash-decode: one query token per sequence attends over a dense
// (B, C, KV, hd) KV cache, the decode cache of the lockstep engine and of
// the continuous engine's dense slot caches.  Validity comes from no mask
// (every row), a (B, C) mask shared by the kv heads, or a per-kv-head
// (B, C, KV) mask (eviction keeps different positions per head; the model
// folds a sliding window into this mask).  A sequence/head with no valid
// row returns exact zeros.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (pallas_call at :80), which takes only the (B, C) mask; the JAX package's
// decode step passes the per-kv-head mask and so runs its jnp reference
// (ref.decode_attention) on a TPU.  This kernel takes both.
//
// Layout: q (B, H, hd); k/v (B, C, KV, hd); mask (B, C) or (B, C, KV) bool;
// out (B, H, hd) in q's type.  fp32 or bf16 payload.
//
// Design: the paged kernel's tile routine (decode_tiles.cuh) with a dense
// row map: one CTA per (kv head, sequence), one warp per query head of the
// GQA group, so each K/V row is read once for the group; a row's mask byte
// is read first and only valid rows' K/V bytes are loaded.
//
// Bound on the H100: bandwidth, the K and V bytes of the valid rows plus
// the mask bytes, q and out, over 3.35 TB/s (~1.4 us for 4 sequences of
// llama3-8b at a 289-row cache).  What this design leaves on the table:
// B*KV CTAs only (32 at 4 sequences, a quarter of the SMs), each walking
// its rows in order with loads and math alternating, so it is
// latency-bound well above that bound (split-K over rows is the lever).
#include "decode_tiles.cuh"

namespace {

// mask kinds (kernels/decode_attention.py passes mask.dim(), 0 for none)
constexpr int MASK_NONE = 0, MASK_ROW = 2, MASK_HEAD = 3;

// Logical row c of sequence b -> its row b * C + c of the cache, -1 when
// masked.
struct DenseRows {
  const uint8_t* mask;
  int kind, C, KV, kvh, b;

  __device__ int row(int c) const {
    const int r = b * C + c;
    bool ok = true;
    if (kind == MASK_ROW) ok = mask[r] != 0;
    else if (kind == MASK_HEAD) ok = mask[(size_t)r * KV + kvh] != 0;
    return ok ? r : -1;
  }
};

template <typename T, int HD>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const uint8_t* __restrict__ mask,
                              T* __restrict__ out, int H, int KV, int C,
                              int kind, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const DenseRows rows{mask, kind, C, KV, kvh, b};
  const size_t head0 = ((size_t)b * H + kvh * G) * HD;
  decode_tiles::attend<T, HD>(q + head0, k, v, out + head0, KV, kvh, G, C,
                              rows, scale, smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, int B, int H, int KV,
                   int C, int kind, cudaStream_t st) {
  const int G = H / KV;
  if (G < 1 || G > 32) return cudaErrorInvalidValue;
  if (kind != MASK_NONE && kind != MASK_ROW && kind != MASK_HEAD)
    return cudaErrorInvalidValue;
  if (kind != MASK_NONE && mask == nullptr) return cudaErrorInvalidValue;
  const int smem = decode_tiles::smem_bytes<HD>(G);
  auto* kern = decode_kernel<T, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, 32 * G, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                   mask, (T*)out, H, KV, C, kind,
                                   1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* out, int B, int H, int KV,
                        int C, int kind, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, mask, out, B, H, KV, C, kind, st);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, H, KV, C, kind, st);
    case 128: return launch<T, 128>(q, k, v, mask, out, B, H, KV, C, kind, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mask_kind: 0 no mask (mask may be null), 2 (B, C), 3 (B, C, KV).
// Returns cudaGetLastError() after launch.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int B, int H,
                                int KV, int C, int hd, int mask_kind,
                                int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k, v, m, out, B, H, KV, C, mask_kind, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, m, out, B, H, KV, C, mask_kind, st);
  return cudaErrorInvalidValue;
}
