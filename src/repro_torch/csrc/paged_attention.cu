// Paged flash-decode: one query token per sequence attends over a KV cache
// that lives in a shared block pool behind a per-sequence block table.
// Logical row c of sequence b is pool[table[b, c / bs], c % bs]; block 0 is
// the null block, whose mask is permanently false.  Validity is per kv head
// (eviction keeps different positions per head).  With window > 0 a row
// also needs new_pos[b] - pos < window.  A sequence/head with no attendable
// row returns exact zeros.
//
// Two entries:
// - paged_decode_attention replaces src/repro/kernels/paged_attention.py,
//   paged_decode_attention_pallas (pallas_call at :152, windowed form
//   :185);
// - paged_decode_masses replaces paged_decode_masses_pallas (:266,
//   pallas_call at :327, windowed form :364): the same output, bitwise,
//   plus every table row's normalised softmax mass per query head,
//   masses (B, H, nb * bs) float32, exact zeros on masked rows (the
//   decode-time eviction scores).  The Pallas kernel re-streams K in a
//   second grid phase; here each lane stores its rows' logits while the
//   tiles stream and rescales them once (m, l) are final (decode_tiles.cuh,
//   MASSES), so K is read once.  Its kernel has a name of its own
//   (paged_masses_kernel), so a profile tells it from paged_decode_kernel.
//
// Layout: q (B, H, hd); k_pool/v_pool (N, bs, KV, hd); mask_pool (N, bs, KV)
// bool; pos_pool (N, bs, KV) int32; table (B, nb) int32; new_pos (B,) int32;
// out (B, H, hd) in q's type.  fp32 or bf16 payload.
//
// Design: one CTA per (kv head, sequence), the shared tile routine of
// decode_tiles.cuh (one warp per query head of the GQA group, only valid
// rows' K/V bytes read).  TPU scalar prefetch has no counterpart: the
// CTA's row map reads table[b, c / bs] itself while it stages a 64-row
// tile (any block size: the tile walks logical rows, each row finds its
// block), so null blocks, ragged tails and dead rows cost their mask byte
// only.
//
// Bound on the H100: bandwidth, the K and V bytes of the valid rows plus
// the mask bytes of every table row, q and out (and the masses), over
// 3.35 TB/s.  What this
// design leaves on the table: only B*KV CTAs (32 at 4 sequences of llama3-8b,
// a quarter of the SMs) each walking its rows in order with loads and math
// alternating (no split-K over the rows, no cp.async/TMA pipelining, no
// tensor cores), so it is latency-bound well above that bound.
#include "decode_tiles.cuh"

namespace {

// Logical row c of one sequence -> its pool row, -1 when masked (or
// outside the window).
struct PagedRows {
  const int32_t* table;  // this sequence's block-table row
  const uint8_t* mask_pool;
  const int32_t* pos_pool;
  int bs, KV, kvh, window, qpos;

  __device__ int row(int c) const {
    const int r = table[c / bs] * bs + c % bs;
    const size_t slot = (size_t)r * KV + kvh;
    bool ok = mask_pool[slot] != 0;
    if (ok && window > 0) ok = qpos - pos_pool[slot] < window;
    return ok ? r : -1;
  }
};

template <typename T, int HD>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const uint8_t* __restrict__ mask_pool,
    const int32_t* __restrict__ pos_pool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ new_pos, T* __restrict__ out, int H, int KV,
    int bs, int nb, int window, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const PagedRows rows{table + (size_t)b * nb, mask_pool, pos_pool, bs, KV,
                       kvh, window, new_pos ? new_pos[b] : 0};
  const size_t head0 = ((size_t)b * H + kvh * G) * HD;
  decode_tiles::attend<T, HD>(q + head0, k_pool, v_pool, out + head0, KV, kvh,
                              G, nb * bs, rows, scale, smem);
}

template <typename T, int HD>
__global__ void paged_masses_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const uint8_t* __restrict__ mask_pool,
    const int32_t* __restrict__ pos_pool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ new_pos, T* __restrict__ out,
    float* __restrict__ masses, int H, int KV, int bs, int nb, int window,
    float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const PagedRows rows{table + (size_t)b * nb, mask_pool, pos_pool, bs, KV,
                       kvh, window, new_pos ? new_pos[b] : 0};
  const size_t head0 = (size_t)b * H + kvh * G;
  decode_tiles::attend<T, HD, PagedRows, true>(
      q + head0 * HD, k_pool, v_pool, out + head0 * HD, KV, kvh, G, nb * bs,
      rows, scale, smem, masses + head0 * nb * bs);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const uint8_t* mask_pool, const int32_t* pos_pool,
                   const int32_t* table, const int32_t* new_pos, void* out,
                   float* masses, int B, int H, int KV, int bs, int nb,
                   int window, cudaStream_t st) {
  const int G = H / KV;
  if (G < 1 || G > 32) return cudaErrorInvalidValue;
  const int smem = decode_tiles::smem_bytes<HD>(G);
  const dim3 grid(KV, B);
  const float scale = 1.f / sqrtf((float)HD);
  cudaError_t err;
  if (masses == nullptr) {
    auto* kern = paged_decode_kernel<T, HD>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, 32 * G, smem, st>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool, mask_pool, pos_pool,
        table, new_pos, (T*)out, H, KV, bs, nb, window, scale);
  } else {
    auto* kern = paged_masses_kernel<T, HD>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, 32 * G, smem, st>>>(
        (const T*)q, (const T*)k_pool, (const T*)v_pool, mask_pool, pos_pool,
        table, new_pos, (T*)out, masses, H, KV, bs, nb, window, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pool,
                        const void* v_pool, const uint8_t* mask_pool,
                        const int32_t* pos_pool, const int32_t* table,
                        const int32_t* new_pos, void* out, float* masses,
                        int B, int H, int KV, int bs, int nb, int window,
                        cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, masses, B, H, KV, bs, nb, window, st);
    case 64: return launch<T, 64>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, masses, B, H, KV, bs, nb, window, st);
    case 128: return launch<T, 128>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, masses, B, H, KV, bs, nb, window, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const void* mask_pool, const void* pos_pool,
                     const void* table, const void* new_pos, void* out,
                     void* masses, int B, int H, int KV, int hd, int bs,
                     int nb, int window, int dtype, cudaStream_t st) {
  const uint8_t* mp = (const uint8_t*)mask_pool;
  const int32_t* pp = (const int32_t*)pos_pool;
  const int32_t* tb = (const int32_t*)table;
  const int32_t* np = (const int32_t*)new_pos;
  float* ms = (float*)masses;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k_pool, v_pool, mp, pp, tb, np, out, ms, B, H, KV, bs, nb, window, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, mp, pp, tb, np, out, ms, B, H, KV, bs, nb, window, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// window <= 0 means no window (pos_pool and new_pos may then be null).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* mask_pool, const void* pos_pool, const void* table,
    const void* new_pos, void* out, int B, int H, int KV, int hd, int bs,
    int nb, int window, int dtype, void* stream) {
  return dispatch(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out,
                  nullptr, B, H, KV, hd, bs, nb, window, dtype,
                  (cudaStream_t)stream);
}

// The same, plus masses (B, H, nb * bs) float32 (must not be null).
extern "C" int paged_decode_masses(
    const void* q, const void* k_pool, const void* v_pool,
    const void* mask_pool, const void* pos_pool, const void* table,
    const void* new_pos, void* out, void* masses, int B, int H, int KV,
    int hd, int bs, int nb, int window, int dtype, void* stream) {
  if (masses == nullptr) return cudaErrorInvalidValue;
  return dispatch(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out,
                  masses, B, H, KV, hd, bs, nb, window, dtype,
                  (cudaStream_t)stream);
}
