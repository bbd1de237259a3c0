// Paged flash-decode: one query token per sequence attends over a KV cache
// that lives in a shared block pool behind a per-sequence block table.
// Logical row c of sequence b is pool[table[b, c / bs], c % bs]; block 0 is
// the null block, whose mask is permanently false.  Validity is per kv head
// (eviction keeps different positions per head).  With window > 0 a row
// also needs new_pos[b] - pos < window.  A sequence/head with no attendable
// row returns exact zeros.
//
// Replaces: src/repro/kernels/paged_attention.py,
// paged_decode_attention_pallas (pallas_call at :152, windowed form :185).
//
// Layout: q (B, H, hd); k_pool/v_pool (N, bs, KV, hd); mask_pool (N, bs, KV)
// bool; pos_pool (N, bs, KV) int32; table (B, nb) int32; new_pos (B,) int32;
// out (B, H, hd) in q's type.  fp32 or bf16 payload.
//
// Design: one CTA per (kv head, sequence) with one warp per query head of
// the GQA group, so each K/V row is read from device memory once for the
// whole group.  TPU scalar prefetch has no counterpart: the CTA reads
// table[b, i] itself while it stages a 64-row tile (any block size: the
// tile walks logical rows, each row finds its block).  A row's validity
// (mask, window) is decided first and only valid rows' K/V bytes are read,
// so null blocks, ragged tails and dead rows cost their mask byte only.
// Each lane then scores two rows against the warp's query (fp32 dot over
// hd from shared memory), the warp runs the online-softmax recurrence and
// accumulates P.V with each lane owning hd/32 output dims.
//
// Bound on the H100: bandwidth, the K and V bytes of the valid rows plus
// the mask bytes of every table row, q and out, over 3.35 TB/s.  What this
// design leaves on the table: only B*KV CTAs (32 at 4 sequences of llama3-8b,
// a quarter of the SMs) each walking its rows in order with loads and math
// alternating (no split-K over the rows, no cp.async/TMA pipelining, no
// tensor cores), so it is latency-bound well above that bound.
#include "common.cuh"

namespace {

constexpr int TR = 64;  // logical rows per tile

template <typename T, int HD>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const uint8_t* __restrict__ mask_pool,
    const int32_t* __restrict__ pos_pool, const int32_t* __restrict__ table,
    const int32_t* __restrict__ new_pos, T* __restrict__ out, int H, int KV,
    int bs, int nb, int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = HD / VEC;
  constexpr int NV = TR * PER_ROW;  // 16-byte vectors per K (or V) tile
  constexpr int UNROLL = 4;
  extern __shared__ float smem[];
  const int G = H / KV;
  float* sK = smem;                 // TR x (HD + 1)
  float* sV = sK + TR * (HD + 1);   // TR x HD
  float* sQ = sV + TR * HD;         // G x HD
  float* sP = sQ + G * HD;          // G x TR
  int* sRow = (int*)(sP + G * TR);  // TR: pool row index, -1 when masked

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid >> 5, lane = tid & 31;
  const int h = kvh * G + g;
  const int rows = nb * bs;
  const int32_t* tb = table + (size_t)b * nb;
  const int qpos = new_pos ? new_pos[b] : 0;

  for (int i = tid; i < G * HD; i += nthreads)
    sQ[i] = to_f32(q[((size_t)b * H + kvh * G) * HD + i]);

  float m = NEG_INF, l = 0.f;
  float acc[HD / 32];
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) acc[i] = 0.f;

  for (int i0 = 0; i0 < rows; i0 += TR) {
    __syncthreads();  // previous tile's readers are done
    for (int j = tid; j < TR; j += nthreads) {
      int prow = -1;
      const int c = i0 + j;
      if (c < rows) {
        const int pb = tb[c / bs];
        const size_t slot = ((size_t)pb * bs + c % bs) * KV + kvh;
        bool ok = mask_pool[slot] != 0;
        if (ok && window > 0) ok = qpos - pos_pool[slot] < window;
        if (ok) prow = pb * bs + c % bs;
      }
      sRow[j] = prow;
    }
    __syncthreads();
    // 16-byte loads of the valid rows, UNROLL per thread in flight at once
    for (int base = tid; base < NV; base += UNROLL * nthreads) {
      uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * nthreads;
        const int prow = i < NV ? sRow[i / PER_ROW] : -1;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (prow >= 0) {
          const size_t o = ((size_t)prow * KV + kvh) * HD + (i % PER_ROW) * VEC;
          kr[u] = *reinterpret_cast<const uint4*>(k_pool + o);
          vr[u] = *reinterpret_cast<const uint4*>(v_pool + o);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * nthreads;
        if (i >= NV) continue;
        const int j = i / PER_ROW, d0 = (i % PER_ROW) * VEC;
        const T* ke = reinterpret_cast<const T*>(&kr[u]);
        const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          sK[j * (HD + 1) + d0 + e] = to_f32(ke[e]);
          sV[j * HD + d0 + e] = to_f32(ve[e]);
        }
      }
    }
    __syncthreads();

    // lane scores rows lane and lane + 32 for this warp's query head
    float s[2];
    bool ok[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      float dot = 0.f;
      for (int d = 0; d < HD; ++d) dot += sQ[g * HD + d] * sK[j * (HD + 1) + d];
      ok[t] = sRow[j] >= 0;
      s[t] = ok[t] ? dot * scale : NEG_INF;
    }
    float tmax = fmaxf(s[0], s[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float p = ok[t] ? expf(s[t] - m_new) : 0.f;
      sP[g * TR + lane + 32 * t] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) acc[i] *= corr;
    for (int j = 0; j < TR; ++j) {
      const float p = sP[g * TR + j];
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) acc[i] += p * sV[j * HD + lane + 32 * i];
    }
  }

  const float inv = 1.f / fmaxf(l, L_FLOOR);
  T* ob = out + ((size_t)b * H + h) * HD;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) ob[lane + 32 * i] = from_f32<T>(acc[i] * inv);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const uint8_t* mask_pool, const int32_t* pos_pool,
                   const int32_t* table, const int32_t* new_pos, void* out,
                   int B, int H, int KV, int bs, int nb, int window,
                   cudaStream_t st) {
  const int G = H / KV;
  if (G < 1 || G > 32) return cudaErrorInvalidValue;
  const int smem = (TR * (HD + 1) + TR * HD + G * HD + G * TR) * sizeof(float)
                   + TR * sizeof(int);
  auto* kern = paged_decode_kernel<T, HD>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, 32 * G, smem, st>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, mask_pool, pos_pool,
      table, new_pos, (T*)out, H, KV, bs, nb, window,
      1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pool,
                        const void* v_pool, const uint8_t* mask_pool,
                        const int32_t* pos_pool, const int32_t* table,
                        const int32_t* new_pos, void* out, int B, int H,
                        int KV, int bs, int nb, int window, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, B, H, KV, bs, nb, window, st);
    case 64: return launch<T, 64>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, B, H, KV, bs, nb, window, st);
    case 128: return launch<T, 128>(q, k_pool, v_pool, mask_pool, pos_pool, table, new_pos, out, B, H, KV, bs, nb, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no window (pos_pool and new_pos may then be null).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* mask_pool, const void* pos_pool, const void* table,
    const void* new_pos, void* out, int B, int H, int KV, int hd, int bs,
    int nb, int window, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* mp = (const uint8_t*)mask_pool;
  const int32_t* pp = (const int32_t*)pos_pool;
  const int32_t* tb = (const int32_t*)table;
  const int32_t* np = (const int32_t*)new_pos;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k_pool, v_pool, mp, pp, tb, np, out, B, H, KV, bs, nb, window, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, mp, pp, tb, np, out, B, H, KV, bs, nb, window, st);
  return cudaErrorInvalidValue;
}
