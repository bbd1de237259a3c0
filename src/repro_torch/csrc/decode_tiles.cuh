// Flash-decode of one query token per (sequence, kv head) over rows that a
// caller-supplied row map resolves, shared by the paged decode kernel
// (paged_attention.cu: rows behind a block table) and the dense decode
// kernel (decode_attention.cu: rows of a (B, C, KV, hd) cache).
//
// One CTA serves the whole GQA group of one kv head, one warp per query
// head, so each K/V row is read from device memory once for the group.
// The CTA walks the logical rows in 64-row tiles.  For each tile it first
// asks the row map which rows are attendable (mask, window) and where
// they live; only those rows' K/V bytes are read (16-byte loads, several
// in flight per thread), the others cost their mask byte.  Each lane then
// scores two rows against its warp's query (fp32 dot over hd from shared
// memory), the warp runs the online-softmax recurrence and accumulates
// P.V with each lane owning hd/32 output dimensions.  A (sequence, kv
// head) with no attendable row writes exact zeros (common.cuh).
//
// With MASSES (the paged decode-masses kernel) each lane also stores its
// two rows' scaled logits (-inf where masked) into its query head's row of
// a float32 mass buffer in global memory while the tiles stream, and after
// the loop rescales them in place to exp(s - m) / max(l, 1e-30) with the
// final (m, l): K is read once.  A lane rescales only the entries it
// stored (rows lane + 32 t of every tile), so no barrier is needed.  The
// flag adds those stores and the rescale and nothing else: the attention
// arithmetic, and so `out`, is the MASSES = false code's.
#pragma once

#include "common.cuh"

namespace decode_tiles {

constexpr int TR = 64;  // logical rows per tile

// Dynamic shared memory of one CTA for head_dim HD and group size G.
template <int HD>
inline int smem_bytes(int G) {
  return (TR * (HD + 1) + TR * HD + G * HD + G * TR) * sizeof(float) +
         TR * sizeof(int);
}

// `rows.row(c)` gives, for logical row c in [0, n_rows), the row index r
// of the K/V arrays, laid out (rows, KV, HD), or -1 when the row may not
// be attended.  q points at the group's first query head (G x HD values),
// out at the group's first output head, and with MASSES `mass` at the
// group's first query head's row of n_rows floats (G rows, back to back).
// Launch with 32 * G threads and smem_bytes<HD>(G) bytes of dynamic shared
// memory at `smem`.
template <typename T, int HD, typename Rows, bool MASSES = false>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int KV, int kvh,
                                       int G, int n_rows, const Rows& rows,
                                       float scale, float* smem,
                                       float* __restrict__ mass = nullptr) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = HD / VEC;
  constexpr int NV = TR * PER_ROW;  // 16-byte vectors per K (or V) tile
  constexpr int UNROLL = 4;
  float* sK = smem;                 // TR x (HD + 1)
  float* sV = sK + TR * (HD + 1);   // TR x HD
  float* sQ = sV + TR * HD;         // G x HD
  float* sP = sQ + G * HD;          // G x TR
  int* sRow = (int*)(sP + G * TR);  // TR: K/V row index, -1 when masked

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid >> 5, lane = tid & 31;

  for (int i = tid; i < G * HD; i += nthreads) sQ[i] = to_f32(q[i]);

  float m = NEG_INF, l = 0.f;
  float acc[HD / 32];
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) acc[i] = 0.f;

  for (int i0 = 0; i0 < n_rows; i0 += TR) {
    __syncthreads();  // previous tile's readers are done
    for (int j = tid; j < TR; j += nthreads) {
      const int c = i0 + j;
      sRow[j] = c < n_rows ? rows.row(c) : -1;
    }
    __syncthreads();
    // 16-byte loads of the valid rows, UNROLL per thread in flight at once
    for (int base = tid; base < NV; base += UNROLL * nthreads) {
      uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * nthreads;
        const int r = i < NV ? sRow[i / PER_ROW] : -1;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (r >= 0) {
          const size_t o = ((size_t)r * KV + kvh) * HD + (i % PER_ROW) * VEC;
          kr[u] = *reinterpret_cast<const uint4*>(k + o);
          vr[u] = *reinterpret_cast<const uint4*>(v + o);
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
      if (MASSES && i0 + j < n_rows)  // -inf where masked: exp gives 0
        mass[g * n_rows + i0 + j] = ok[t] ? s[t]
                                          : __int_as_float(0xff800000);
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
#pragma unroll
  for (int i = 0; i < HD / 32; ++i)
    out[g * HD + lane + 32 * i] = from_f32<T>(acc[i] * inv);
  if (MASSES) {
    // exp(-inf - m) is exactly 0: masked rows and empty heads stay zero
    for (int c = lane; c < n_rows; c += 32) {
      float* p = mass + g * n_rows + c;
      *p = expf(*p - m) * inv;
    }
  }
}

}  // namespace decode_tiles
