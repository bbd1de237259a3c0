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
//   second grid phase; here the rows' logits wait in shared memory while
//   the rows stream and are rescaled once the cluster's (m, l) are final
//   (decode_split.cuh, MASSES), so K is read once.  Its kernel has a name
//   of its own (paged_masses_kernel), so a profile tells it from
//   paged_decode_kernel.
//
// Layout: q (B, H, hd); k_pool/v_pool (N, bs, KV, hd); mask_pool (N, bs, KV)
// bool; pos_pool (N, bs, KV) int32; table (B, nb) int32; new_pos (B,) int32;
// out (B, H, hd) in q's type.  fp32 or bf16 payload.
//
// Design (decode_split.cuh): a thread-block cluster of n_split CTAs per
// (sequence, kv head), grid (n_split, KV, B), one launch.  CTA rank s
// takes blocks [nb * s / n_split, nb * (s + 1) / n_split) of the table
// (a rank with none contributes nothing); its four warps split that row
// range, each lane reading the block table itself (TPU scalar prefetch
// has no counterpart) two 32-row batches ahead.  A row's K/V copy
// (cp.async into a per-lane shared-memory ring, up to 8 steps ahead)
// needs only its table entry, so it flies beside the row's mask load; a
// null block's rows are not read, a masked row's are read with its block
// and zeroed.  All G query heads are scored from registers.  The CTAs
// merge in rank order through distributed shared memory.  n_split comes
// from the caller (kernels/paged_attention.py: row_splits, from the
// shapes and the SM count); a cluster launch the card refuses returns its
// error, with no fallback to one CTA per (sequence, kv head).
//
// Bound on the H100: bandwidth, the K and V bytes of the valid rows plus
// the mask bytes of every table row, q and out (and the masses), over
// 3.35 TB/s, ~1.3 us for 4 sequences of llama3-8b at 19 blocks of 16.
// What this design leaves on the table: a call moves a few MB, so it is
// latency-bound: the launch, two dependent round trips to memory before
// the first row is scored (table entry, then mask byte and K/V), the row
// steps of each warp (dot products reduced by shuffles on CUDA cores, not
// tensor cores: a decode token's G = 4 query rows would fill a
// tensor-core tile a sixteenth), and the cluster barrier before the
// merge.  One live slot of four fills only KV * n_split = 32 CTAs at 4
// splits (8 splits lost: their 256 CTAs take a second wave).
#include "decode_split.cuh"

namespace {

// Logical row c of one sequence -> its pool row (the block table), then
// its mask byte and position (decode_split.cuh's row-map interface).
struct PagedRows {
  const int32_t* table;  // this sequence's block-table row
  const uint8_t* mask_pool;
  const int32_t* pos_pool;
  int bs, KV, kvh, window, qpos;

  __device__ int where(int c) const {
    return __ldg(table + c / bs) * bs + c % bs;
  }
  // the null block (0) holds no data: its mask is permanently false
  __device__ bool stored(int r) const { return r >= bs; }
  __device__ int2 probe(int r) const {
    const size_t slot = (size_t)r * KV + kvh;
    return make_int2(__ldg(mask_pool + slot),
                     window > 0 ? __ldg(pos_pool + slot) : 0);
  }
  __device__ bool alive(int2 w) const {
    return w.x != 0 && (window <= 0 || qpos - w.y < window);
  }
};

// Grid (n_split, KV, B) in clusters of (n_split, 1, 1).
template <typename T, int HD, bool MASSES>
__device__ __forceinline__ void paged_body(
    const T* q, const T* k_pool, const T* v_pool, const uint8_t* mask_pool,
    const int32_t* pos_pool, const int32_t* table, const int32_t* new_pos,
    T* out, float* masses, int H, int KV, int bs, int nb, int window,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int s = decode_split::cluster_rank();
  const int n_split = decode_split::cluster_size();
  const int blk0 = nb * s / n_split, blk1 = nb * (s + 1) / n_split;
  const PagedRows rows{table + (size_t)b * nb, mask_pool, pos_pool, bs, KV,
                       kvh, window, window > 0 ? new_pos[b] : 0};
  const size_t head0 = (size_t)b * H + kvh * G;
  decode_split::attend<T, HD, MASSES>(
      q + head0 * HD, k_pool, v_pool, out + head0 * HD,
      MASSES ? masses + head0 * nb * bs : nullptr, KV, kvh, G, nb * bs,
      blk0 * bs, blk1 * bs, rows, scale, smem);
}

template <typename T, int HD>
__global__ void __launch_bounds__(decode_split::THREADS, 1) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const uint8_t* __restrict__ mask_pool,
    const int32_t* __restrict__ pos_pool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ new_pos, T* __restrict__ out, int H, int KV,
    int bs, int nb, int window, float scale) {
  paged_body<T, HD, false>(q, k_pool, v_pool, mask_pool, pos_pool, table,
                               new_pos, out, nullptr, H, KV, bs, nb, window,
                               scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(decode_split::THREADS, 1) paged_masses_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const uint8_t* __restrict__ mask_pool,
    const int32_t* __restrict__ pos_pool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ new_pos, T* __restrict__ out,
    float* __restrict__ masses, int H, int KV, int bs, int nb, int window,
    float scale) {
  paged_body<T, HD, true>(q, k_pool, v_pool, mask_pool, pos_pool, table,
                              new_pos, out, masses, H, KV, bs, nb, window,
                              scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const uint8_t* mask_pool, const int32_t* pos_pool,
                   const int32_t* table, const int32_t* new_pos, void* out,
                   float* masses, int B, int H, int KV, int bs, int nb,
                   int window, int n_split, cudaStream_t st) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KV, B);
  cfg.blockDim = dim3(decode_split::THREADS);
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const float scale = 1.f / sqrtf((float)HD);
  cudaError_t err;
  if (masses == nullptr) {
    auto* kern = paged_decode_kernel<T, HD>;
    cfg.dynamicSmemBytes = decode_split::Shape<T, HD, false>::BYTES;
    static const cudaError_t allowed = allow_smem(kern, cfg.dynamicSmemBytes);
    if (allowed != cudaSuccess) return allowed;
    err = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k_pool,
                             (const T*)v_pool, mask_pool, pos_pool, table,
                             new_pos, (T*)out, H, KV, bs, nb, window, scale);
  } else {
    auto* kern = paged_masses_kernel<T, HD>;
    cfg.dynamicSmemBytes = decode_split::Shape<T, HD, true>::BYTES;
    static const cudaError_t allowed = allow_smem(kern, cfg.dynamicSmemBytes);
    if (allowed != cudaSuccess) return allowed;
    err = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k_pool,
                             (const T*)v_pool, mask_pool, pos_pool, table,
                             new_pos, (T*)out, masses, H, KV, bs, nb, window,
                             scale);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pool,
                        const void* v_pool, const uint8_t* mask_pool,
                        const int32_t* pos_pool, const int32_t* table,
                        const int32_t* new_pos, void* out, float* masses,
                        int B, int H, int KV, int bs, int nb, int window,
                        int n_split, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, masses, B, H, KV, bs, nb, window, n_split, st);
    case 64: return launch<T, 64>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, masses, B, H, KV, bs, nb, window, n_split, st);
    case 128: return launch<T, 128>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, masses, B, H, KV, bs, nb, window, n_split, st);
    case 256: return launch<T, 256>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, masses, B, H, KV, bs, nb, window, n_split, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const void* mask_pool, const void* pos_pool,
                     const void* table, const void* new_pos, void* out,
                     void* masses, int B, int H, int KV, int hd, int bs,
                     int nb, int window, int n_split, int dtype,
                     cudaStream_t st) {
  if (KV < 1 || H % KV || H / KV > 32 || nb < 1 || bs < 1 || n_split < 1 ||
      n_split > decode_split::MAX_SPLITS)
    return cudaErrorInvalidValue;
  const uint8_t* mp = (const uint8_t*)mask_pool;
  const int32_t* pp = (const int32_t*)pos_pool;
  const int32_t* tb = (const int32_t*)table;
  const int32_t* np = (const int32_t*)new_pos;
  float* ms = (float*)masses;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k_pool, v_pool, mp, pp, tb, np, out, ms, B, H, KV, bs, nb, window, n_split, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, mp, pp, tb, np, out, ms, B, H, KV, bs, nb, window, n_split, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// window <= 0 means no window (pos_pool and new_pos may then be null).
// n_split: CTAs per (sequence, kv head), 1 to 8, one cluster.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* mask_pool, const void* pos_pool, const void* table,
    const void* new_pos, void* out, int B, int H, int KV, int hd, int bs,
    int nb, int window, int n_split, int dtype, void* stream) {
  return dispatch(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out,
                  nullptr, B, H, KV, hd, bs, nb, window, n_split, dtype,
                  (cudaStream_t)stream);
}

// The same, plus masses (B, H, nb * bs) float32 (must not be null).
extern "C" int paged_decode_masses(
    const void* q, const void* k_pool, const void* v_pool,
    const void* mask_pool, const void* pos_pool, const void* table,
    const void* new_pos, void* out, void* masses, int B, int H, int KV,
    int hd, int bs, int nb, int window, int n_split, int dtype,
    void* stream) {
  if (masses == nullptr) return cudaErrorInvalidValue;
  return dispatch(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out,
                  masses, B, H, KV, hd, bs, nb, window, n_split, dtype,
                  (cudaStream_t)stream);
}
