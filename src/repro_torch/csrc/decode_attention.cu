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
// Design: the paged kernels' cluster-split routine (decode_split.cuh) with
// a dense row map.  A thread-block cluster of n_split CTAs per (sequence,
// kv head), grid (n_split, KV, B), one launch; CTA rank s takes rows
// [C * s / n_split, C * (s + 1) / n_split).  A row's place is its index,
// so the routine's copy of its K/V (cp.async into a per-lane ring) starts
// beside its mask load: one dependent round trip per row, where the paged
// kernels have two (block table, then mask and K/V).  n_split comes from
// the caller (kernels/decode_attention.py: row_splits, from the shapes and
// the SM count); a cluster launch the card refuses returns its error, with
// no fallback.
//
// Bound on the H100: bandwidth, the K and V bytes of the valid rows plus
// the mask bytes, q and out, over 3.35 TB/s (~1.3 us for 4 sequences of
// llama3-8b at a 289-row cache).  What this design leaves on the table:
// the call moves ~2 MB, so it is latency-bound: the launch, one cold round
// trip before the first row is scored, the row steps of each warp on CUDA
// cores, and the cluster barrier before the merge (decode_split.cuh).
#include "decode_split.cuh"

namespace {

// mask kinds (kernels/decode_attention.py passes mask.dim(), 0 for none)
constexpr int MASK_NONE = 0, MASK_ROW = 2, MASK_HEAD = 3;

// Logical row c of sequence b is row b * C + c of the cache; its validity
// is its mask byte (decode_split.cuh's row-map interface).
struct DenseRows {
  const uint8_t* mask;
  int kind, C, KV, kvh, b;

  __device__ int where(int c) const { return b * C + c; }
  __device__ bool stored(int) const { return true; }
  __device__ int2 probe(int r) const {
    if (kind == MASK_ROW) return make_int2(__ldg(mask + r), 0);
    if (kind == MASK_HEAD)
      return make_int2(__ldg(mask + (size_t)r * KV + kvh), 0);
    return make_int2(1, 0);
  }
  __device__ bool alive(int2 w) const { return w.x != 0; }
};

// Grid (n_split, KV, B) in clusters of (n_split, 1, 1).
template <typename T, int HD>
__global__ void __launch_bounds__(decode_split::THREADS, 1) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ mask,
    T* __restrict__ out, int H, int KV, int C, int kind, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int s = decode_split::cluster_rank();
  const int n_split = decode_split::cluster_size();
  const DenseRows rows{mask, kind, C, KV, kvh, b};
  const size_t head0 = (size_t)b * H + kvh * G;
  decode_split::attend<T, HD, false>(
      q + head0 * HD, k, v, out + head0 * HD, nullptr, KV, kvh, G, C,
      C * s / n_split, C * (s + 1) / n_split, rows, scale, smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, int B, int H, int KV,
                   int C, int kind, int n_split, cudaStream_t st) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KV, B);
  cfg.blockDim = dim3(decode_split::THREADS);
  cfg.dynamicSmemBytes = decode_split::Shape<T, HD, false>::BYTES;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  auto* kern = decode_kernel<T, HD>;
  static const cudaError_t allowed = allow_smem(kern, cfg.dynamicSmemBytes);
  if (allowed != cudaSuccess) return allowed;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, H,
      KV, C, kind, 1.f / sqrtf((float)HD));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* out, int B, int H, int KV,
                        int C, int kind, int n_split, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, mask, out, B, H, KV, C, kind, n_split, st);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, H, KV, C, kind, n_split, st);
    case 128: return launch<T, 128>(q, k, v, mask, out, B, H, KV, C, kind, n_split, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mask_kind: 0 no mask (mask may be null), 2 (B, C), 3 (B, C, KV).
// n_split: CTAs per (sequence, kv head), 1 to 8, one cluster.
// Returns the launch's error (cudaGetLastError() after it).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int B, int H,
                                int KV, int C, int hd, int mask_kind,
                                int n_split, int dtype, void* stream) {
  if (KV < 1 || H % KV || H / KV < 1 || H / KV > 32 || C < 0 ||
      n_split < 1 || n_split > decode_split::MAX_SPLITS)
    return cudaErrorInvalidValue;
  if (mask_kind != MASK_NONE && mask_kind != MASK_ROW &&
      mask_kind != MASK_HEAD)
    return cudaErrorInvalidValue;
  if (mask_kind != MASK_NONE && mask == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k, v, m, out, B, H, KV, C, mask_kind, n_split, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, m, out, B, H, KV, C, mask_kind, n_split, st);
  return cudaErrorInvalidValue;
}
