// LookaheadKV importance scores, the paper's scoring hot spot:
//
//   scores[b, h, j] = (1 / n_obs) * sum_i softmax_i(q_obs . K^T / sqrt(hd))[j]
//
// for the first n_prompt keys.  Observation row i sits at absolute position
// q_offset + i and is causal among the observation rows; kv_mask (B,
// n_prompt) hides prompt keys, row_valid (B, n_obs) zeroes whole rows (the
// denominator stays n_obs), an optional window hides keys with
// q_pos - k_pos >= window.  Output (B, H, n_prompt) float32.
//
// Replaces: src/repro/kernels/lookahead_score.py, lookahead_score_pallas
// (pallas_call at :156).
//
// The TPU kernel runs its key axis twice inside one sequential grid (phase
// 0 accumulates each row's (m, l), phase 1 re-streams the keys and emits
// column means).  A GPU grid has no order between blocks, so here the one
// TPU kernel becomes two launches on the same stream:
//   1. obs_row_stats: one CTA per (key split, 32-row tile, head, batch)
//      streams its share of the visible keys and writes each row's partial
//      (m, l) to a float32 scratch (B, H, n_split, n_obs);
//   2. obs_column_means: one CTA per (64-key tile, head, batch) merges the
//      partials into each row's final (m, l) (m = max m_s, l = sum l_s
//      exp(m_s - m)), recomputes its tile's logits for every row, turns
//      them into exp(s - m) / l and sums them over rows.  Tiles past the
//      last visible key (q_offset + n_obs - 1) write exact zeros.
// Layout: q_obs (B, n_obs, H, hd), k (B, Sk, KV, hd) contiguous, fp32/bf16.
//
// Bound on the H100: bandwidth, the bytes of q_obs, the visible key rows
// (each read once) and the output over 3.35 TB/s; the 2*hd*H*n_obs*keys
// operations are far below the bf16 peak.  What this design leaves on the
// table: the keys are read twice (once per launch), the logits are computed
// twice, no tensor cores, no TMA.
#include "common.cuh"

namespace {

constexpr int RQ = 32;        // observation rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 8 lanes per row, 8 keys per lane
constexpr int NJ = BK / 8;

// Mask of key kpos for the row at qpos.
__device__ __forceinline__ bool key_ok(int kpos, int qpos, int Sk,
                                       int n_prompt, int window,
                                       const uint8_t* kv_mask_b) {
  if (kpos >= Sk || kpos > qpos) return false;
  if (window > 0 && qpos - kpos >= window) return false;
  if (kv_mask_b != nullptr && kpos < n_prompt && !kv_mask_b[kpos]) return false;
  return true;
}

// Stage NROWS rows of HD elements into shared memory as float (row stride
// HD + 1): every thread issues all its 16-byte loads before converting and
// storing, so the loads are in flight together.  Rows at or past `limit`
// are zeros.
template <typename T, int HD, int NROWS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t row_stride, int row0,
                                           int limit) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = HD / VEC;
  constexpr int N = NROWS * PER_ROW;
  constexpr int ITERS = (N + THREADS - 1) / THREADS;
  uint4 buf[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = i % PER_ROW;
    buf[it] = (i < N && row0 + r < limit)
                  ? *reinterpret_cast<const uint4*>(
                        src + (size_t)(row0 + r) * row_stride + c * VEC)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i < N) {
      const int r = i / PER_ROW, c = i % PER_ROW;
      const T* e = reinterpret_cast<const T*>(&buf[it]);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst[r * (HD + 1) + c * VEC + j] = to_f32(e[j]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void tile_dots(const float* sQ, const float* sK,
                                          int r, int c8, float* s) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j] = 0.f;
  for (int d = 0; d < HD; ++d) {
    const float qd = sQ[r * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] += qd * sK[(c8 + 8 * j) * (HD + 1) + d];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
obs_row_stats(const T* __restrict__ q, const T* __restrict__ k,
              const uint8_t* __restrict__ kv_mask, float* __restrict__ m_out,
              float* __restrict__ l_out, int n_obs, int H, int Sk, int KV,
              int n_prompt, int q_offset, int window, int n_split,
              float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                // RQ x (HD + 1)
  float* sK = sQ + RQ * (HD + 1);  // BK x (HD + 1)
  const int split = blockIdx.x % n_split;
  const int r0 = (blockIdx.x / n_split) * RQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const T* qb = q + (size_t)b * n_obs * H * HD + (size_t)h * HD;
  const T* kb = k + (size_t)b * Sk * KV * HD + (size_t)kvh * HD;
  const uint8_t* kvm = kv_mask ? kv_mask + (size_t)b * n_prompt : nullptr;

  stage_rows<T, HD, RQ>(sQ, qb, (size_t)H * HD, r0, n_obs);
  const int rows = min(RQ, n_obs - r0);
  const int k_end = min(Sk, q_offset + r0 + rows);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_offset + r0 - window + 1) / BK) * BK;
  // this split's share of the visible key tiles
  const int tiles = (max(k_end - k_begin, 0) + BK - 1) / BK;
  const int per = (tiles + n_split - 1) / n_split;
  const int s_end = min(k_end, k_begin + (split + 1) * per * BK);
  k_begin += split * per * BK;
  const int qpos = q_offset + r0 + r;

  float m = NEG_INF, l = 0.f;
  for (int k0 = k_begin; k0 < s_end; k0 += BK) {
    __syncthreads();
    stage_rows<T, HD, BK>(sK, kb + (size_t)k0 * KV * HD, (size_t)KV * HD, 0,
                          Sk - k0);
    __syncthreads();
    float s[NJ];
    tile_dots<HD>(sQ, sK, r, c8, s);
    unsigned okbits = 0;
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool ok = key_ok(k0 + c8 + 8 * j, qpos, Sk, n_prompt, window, kvm);
      s[j] = ok ? s[j] * scale : NEG_INF;
      okbits |= (unsigned)ok << j;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      psum += ((okbits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * expf(m - m_new) + psum;
    m = m_new;
  }
  if (c8 == 0 && r0 + r < n_obs) {
    const size_t o = (((size_t)b * H + h) * n_split + split) * n_obs + r0 + r;
    m_out[o] = m;
    l_out[o] = l;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
obs_column_means(const T* __restrict__ q, const T* __restrict__ k,
                 const uint8_t* __restrict__ kv_mask,
                 const uint8_t* __restrict__ row_valid,
                 const float* __restrict__ m_in, const float* __restrict__ l_in,
                 float* __restrict__ out, int n_obs, int H, int Sk, int KV,
                 int n_prompt, int q_offset, int window, int n_split,
                 float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                 // RQ x (HD + 1)
  float* sK = sQ + RQ * (HD + 1);   // BK x (HD + 1)
  float* sRed = sK + BK * (HD + 1); // RQ x (BK + 1)
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid >> 3, c8 = tid & 7;
  float* ob = out + ((size_t)b * H + h) * n_prompt;

  if (k0 > q_offset + n_obs - 1) {  // no row can see this tile
    for (int c = tid; c < BK; c += THREADS)
      if (k0 + c < n_prompt) ob[k0 + c] = 0.f;
    return;
  }
  const T* qb = q + (size_t)b * n_obs * H * HD + (size_t)h * HD;
  const T* kb = k + (size_t)b * Sk * KV * HD + (size_t)kvh * HD;
  const uint8_t* kvm = kv_mask ? kv_mask + (size_t)b * n_prompt : nullptr;
  const float* mb = m_in + ((size_t)b * H + h) * n_split * n_obs;
  const float* lb = l_in + ((size_t)b * H + h) * n_split * n_obs;

  stage_rows<T, HD, BK>(sK, kb + (size_t)k0 * KV * HD, (size_t)KV * HD, 0,
                        Sk - k0);
  float col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = 0.f;

  for (int r0 = 0; r0 < n_obs; r0 += RQ) {
    __syncthreads();  // sK staged / previous row tile's readers done
    stage_rows<T, HD, RQ>(sQ, qb, (size_t)H * HD, r0, n_obs);
    __syncthreads();
    const int row = r0 + r;
    if (row >= n_obs) continue;
    if (row_valid != nullptr && !row_valid[(size_t)b * n_obs + row]) continue;
    float m = NEG_INF, l = 0.f;  // merge the key splits' partials
    for (int sp = 0; sp < n_split; ++sp) m = fmaxf(m, mb[sp * n_obs + row]);
    for (int sp = 0; sp < n_split; ++sp)
      l += lb[sp * n_obs + row] * expf(mb[sp * n_obs + row] - m);
    const float inv_l = 1.f / fmaxf(l, L_FLOOR);
    const int qpos = q_offset + row;
    float s[NJ];
    tile_dots<HD>(sQ, sK, r, c8, s);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bool ok = key_ok(k0 + c8 + 8 * j, qpos, Sk, n_prompt, window, kvm);
      col[j] += ok ? expf(s[j] * scale - m) * inv_l : 0.f;
    }
  }
  // sum the per-row partials of each key column
#pragma unroll
  for (int j = 0; j < NJ; ++j) sRed[r * (BK + 1) + c8 + 8 * j] = col[j];
  __syncthreads();
  for (int c = tid; c < BK; c += THREADS) {
    float tot = 0.f;
    for (int rr = 0; rr < RQ; ++rr) tot += sRed[rr * (BK + 1) + c];
    if (k0 + c < n_prompt) ob[k0 + c] = tot / (float)n_obs;
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const uint8_t* kv_mask,
                   const uint8_t* row_valid, float* m_buf, float* l_buf,
                   float* out, int B, int n_obs, int H, int Sk, int KV,
                   int n_prompt, int q_offset, int window, int n_split,
                   cudaStream_t st) {
  const float scale = 1.f / sqrtf((float)HD);
  const int smem1 = (RQ + BK) * (HD + 1) * sizeof(float);
  const int smem2 = smem1 + RQ * (BK + 1) * sizeof(float);
  auto* k1 = obs_row_stats<T, HD>;
  auto* k2 = obs_column_means<T, HD>;
  cudaError_t err = allow_smem(k1, smem1);
  if (err == cudaSuccess) err = allow_smem(k2, smem2);
  if (err != cudaSuccess) return err;
  dim3 g1(n_split * ((n_obs + RQ - 1) / RQ), H, B);
  k1<<<g1, THREADS, smem1, st>>>((const T*)q, (const T*)k, kv_mask, m_buf,
                                 l_buf, n_obs, H, Sk, KV, n_prompt, q_offset,
                                 window, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2((n_prompt + BK - 1) / BK, H, B);
  k2<<<g2, THREADS, smem2, st>>>((const T*)q, (const T*)k, kv_mask,
                                 row_valid, m_buf, l_buf, out, n_obs, H, Sk,
                                 KV, n_prompt, q_offset, window, n_split,
                                 scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k,
                        const uint8_t* kv_mask, const uint8_t* row_valid,
                        float* m_buf, float* l_buf, float* out, int B,
                        int n_obs, int H, int Sk, int KV, int n_prompt,
                        int q_offset, int window, int n_split,
                        cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, kv_mask, row_valid, m_buf, l_buf, out, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, st);
    case 64: return launch<T, 64>(q, k, kv_mask, row_valid, m_buf, l_buf, out, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, st);
    case 128: return launch<T, 128>(q, k, kv_mask, row_valid, m_buf, l_buf, out, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_mask / row_valid may be null (all keys / rows valid); window <= 0
// means no window.  m_buf / l_buf are (B, H, n_split, n_obs) float32
// scratch; n_split >= 1 key splits share pass 1.
extern "C" int lookahead_score(const void* q, const void* k,
                               const void* kv_mask, const void* row_valid,
                               void* m_buf, void* l_buf, void* out, int B,
                               int n_obs, int H, int Sk, int KV, int hd,
                               int n_prompt, int q_offset, int window,
                               int n_split, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* km = (const uint8_t*)kv_mask;
  const uint8_t* rv = (const uint8_t*)row_valid;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k, km, rv, (float*)m_buf, (float*)l_buf, (float*)out, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, km, rv, (float*)m_buf, (float*)l_buf, (float*)out, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, st);
  return cudaErrorInvalidValue;
}
