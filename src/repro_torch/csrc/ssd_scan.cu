// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060), the
// selective state-space recurrence of the SSM and hybrid archs' prefill:
//
//   per (batch, head), state h (hd x ds) carried across chunks of Q rows;
//   inside a chunk, with L = cumsum(A dt) and every exponent clipped to
//   [-60, 0]:
//     y_t = sum_{s<=t} (C_t.B_s) exp(L_t - L_s) dt_s x_s + (C_t.h) exp(L_t)
//     h  <- exp(L_Q) h + sum_s exp(L_Q - L_s) dt_s x_s (x) B_s
//
// B and C have one group, shared by every head.  A ragged last chunk
// behaves as the plain version's zero padding (pad rows have dt = 0, so
// they add nothing and leave the state unchanged): L_Q is taken at the
// chunk's last real row.
//
// Replaces: src/repro/kernels/ssd_scan.py:75, ssd_scan_pallas (pallas_call
// at :99), which runs the chunk axis in order on one core and keeps the
// state in VMEM.  That kernel asserts S % chunk == 0 and nh % block_nh ==
// 0; this one takes any S >= 1, any nh and any chunk of 1..256 rows.
//
// Layout: x (B, S, nh, hd) with row stride x_row between consecutive (b,
// s) and batch stride S * x_row; B/C (B, S, 1, ds) with row strides b_row /
// c_row (the model passes views of its conv output); dt (B, S, nh) f32;
// A (nh,) f32; initial state (B, nh, hd, ds) f32 or null (zeros).  Outputs
// y (B, S, nh, hd) f32 and the final state (B, nh, hd, ds) f32.  Scratch,
// written in full by launch (a), so the wrapper needs no memset: the
// chunk states (B, nc, nh, hd, ds) f32, L_Q (B, nc, nh) f32 and, in bf16,
// each chunk's C.B^T.
//
// Design: Mamba-2's own GPU split, three launches on the stream, (b) and
// (c) programmatic dependent launches:
//   (a) chunk states, grid (chunks, head blocks, B): per head the prefix
//       sum L, L_Q and dh_c = sum_s exp(L_Q - L_s) dt_s x_s (x) B_s into
//       chunk slot c of the scratch;
//   (b) state pass, one thread per 4 state elements: h from h0 (or 0);
//       for c = 0..nc-1 slot c becomes the state entering chunk c, then
//       h <- exp(L_Q,c) h + dh_c; the last h is the final state;
//   (c) chunk scan, grid (chunks, head blocks, B): y from the chunk's own
//       rows and the state entering it.
// Every chunk is a CTA of its own, so the chunks run side by side
// (hymba-1.5b's prefill: 448 CTAs of 8 heads, 200 CTAs before) and only
// the state pass walks them in order, 4 elements a thread.  L is summed
// in row order, as the plain version's cumsum.
//
// bf16 inputs (the served models) take mma.sync m16n8k16, float32
// accumulators, 8 warps, for the products with heads:
//   - (a): dh_c^T = (x_s exp(L_Q - L_s) dt_s)^T . B, an (hd x chunk) by
//     (chunk x ds) product; the scaled x is float32, so it enters as two
//     bf16 operands, hi = bf16(v) and lo = bf16(v - hi), and the two
//     products are summed (residual at most 2^-16 of v); B is exact.
//   - (c): per head W = C.B^T o exp(L_t - L_s) o causal with dt_s folded
//     in, built in registers from C.B^T's mma fragments, split hi/lo,
//     times x (exact); the carried term C . h^T, each row scaled by
//     exp(L_t), with the incoming state split in three, hi, mid and lo
//     (residual 2^-24): a row at a chunk's start can be small against
//     |C| |h|, and there hi/lo put a few rows of mamba2-130m's prefill past
//     the 2^-12 tolerance.  A warp takes one 16-row slab of the 128-row
//     tile and the whole head dim, so each weight is formed once; per head
//     x and the incoming state go through two cp.async buffers.
// C.B^T is shared by the heads (one group): (a)'s CTAs of a chunk share it
// out, 16 rows by 16 columns a unit, the causal blocks only, and store it
// in mma fragment order for (c).  It runs on float32 FMA over d in order,
// not on tensor cores: where C_t.B_t cancels (to a small fraction of
// sum_d |C_t,d B_t,d|) and carries its row of y, a tensor-core sum's
// truncation put the row past the tolerance on the card, and this order
// rounds as the plain version does.  d_state 8 pads the k depth of C.h^T
// to 16 with zeros.
// float32 inputs (the smoke configs) keep CUDA-core FMA arithmetic in the
// same three launches, one head per CTA: a tensor-core product of float32
// inputs would round them.
//
// Bound on the H100: bytes.  One pass over x, B, C, dt, y and the states
// is ~160 MB at hymba-1.5b's lockstep prefill (B 4 x S 2048 x 50 heads of
// 64, d_state 16: ~0.048 ms) and ~84 MB at mamba2-130m's (24 heads,
// d_state 128: ~0.025 ms); on tensor cores the operations take a few us.
// This design moves more: x is read by (a) and (c), and the chunk states
// are written by (a), read and written by (b) and read by (c): ~265 MB at
// hymba's shape, ~312 MB at mamba2's, 201 MB of it chunk states (d_state
// 128), more than the 50 MB L2 holds.  A one-launch form that chains the
// states from chunk CTA to chunk CTA (L2 flags or distributed shared
// memory) would keep them on chip.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB, a CTA's dynamic shared memory

__device__ __forceinline__ float decay(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
}

// The same through the approximate exponential (ex2.approx of x log2 e,
// within 2 + 1.16 |x| ulp of exp, under 2^-17 over the clipped range):
// the weights of launch (c) take one for each (t, s) pair of every head
// and chunk.
__device__ __forceinline__ float fast_decay(float x) {
  return __expf(fminf(fmaxf(x, -60.f), 0.f));
}

__host__ __device__ constexpr int r16(int n) { return (n + 15) / 16 * 16; }

// dt of the nbh heads n0 + j hstep (j < nbh) for the chunk's rows into
// sdt[j * q16 + r] (zeros past nv up to r16(nv)), then, one thread a head, the
// inclusive prefix sum of the log-decays A dt in row order into L[j * q16
// + r] up to r16(nv) (past nv it stays at its last real value).  Products
// and sums are rounded one by one, as the plain version's cumsum of A * dt
// takes them: near the diagonal exp(L_t - L_s) of two large L is only as
// good as their float32 rounding, so the two sides round alike.  Ends in
// a barrier.
__device__ __forceinline__ void chunk_decays(const float* dt, const float* A,
                                             size_t row0, int nh, int n0,
                                             int hstep, int nbh, int nv,
                                             int q16, float* sdt, float* L) {
  const int n16 = r16(nv);
  for (int e = threadIdx.x; e < nbh * n16; e += THREADS) {
    const int r = e / nbh, j = e % nbh;
    sdt[j * q16 + r] = r < nv ? dt[(row0 + r) * nh + n0 + j * hstep] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nbh; j += THREADS) {
    const float a = A[n0 + j * hstep];
    const float* sj = sdt + j * q16;
    float* lj = L + j * q16;
    float v = 0.f;
    for (int r0 = 0; r0 < n16; r0 += 16) {
      float d[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) d[u] = sj[r0 + u];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        v = __fadd_rn(v, __fmul_rn(a, d[u]));
        lj[r0 + u] = v;
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// launch (b): the state pass
// ---------------------------------------------------------------------------

// states (B, nc, nh, hd * ds): chunk c's dh_c in, the state entering chunk
// c out; lq (B, nc, nh).  Thread i carries elements 4i .. 4i + 3 of the
// (B, nh, hd * ds) state, loading 8 chunks' dh and L_Q ahead.
__global__ void __launch_bounds__(THREADS)
    ssd_state_pass(float* __restrict__ states, const float* __restrict__ lq,
                   const float* __restrict__ h0, float* __restrict__ hout,
                   int B, int nc, int nh, int hdds) {
  launch_dependents();  // launch (c) may start and stage its C.B^T
  wait_for_predecessor();
  const int per = hdds / 4;
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * nh * per) return;
  const int e = (int)(i % per);
  const int bn = (int)(i / per), b = bn / nh, n = bn % nh;
  float4 h = h0 != nullptr ? reinterpret_cast<const float4*>(h0)[i]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* st = reinterpret_cast<float4*>(states);
  constexpr int AHEAD = 8;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 d[AHEAD];
    float q[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < nc) {
        const size_t slot = ((size_t)b * nc + c0 + u) * nh + n;
        d[u] = st[slot * per + e];
        q[u] = lq[slot];
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < nc) {
        const size_t slot = ((size_t)b * nc + c0 + u) * nh + n;
        st[slot * per + e] = h;
        const float r = decay(q[u]);
        h = make_float4(r * h.x + d[u].x, r * h.y + d[u].y, r * h.z + d[u].z,
                        r * h.w + d[u].w);
      }
    }
  }
  reinterpret_cast<float4*>(hout)[i] = h;
}

// ---------------------------------------------------------------------------
// float32 inputs: launches (a) and (c) on CUDA cores, one CTA per (chunk,
// head, sequence)
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int TILE = 64;        // rows of a t- or s-tile inside a chunk
constexpr int WP = TILE + 1;    // row stride of the weight tile

// Shared memory of one CTA, in floats: (a) u, a B tile, L and dt (rows
// padded to 16), exp(L_Q - L_s); (c) also the state, a C tile and the
// weights.
__host__ __device__ constexpr int states_floats(int hd, int ds, int chunk) {
  return chunk * (hd + 1) + TILE * (ds + 1) + 2 * r16(chunk) + chunk;
}
__host__ __device__ constexpr int scan_floats(int hd, int ds, int chunk) {
  return hd * (ds + 1) + chunk * (hd + 1) + 2 * TILE * (ds + 1) + TILE * WP +
         2 * r16(chunk);
}

// u = dt x for the chunk's rows (row stride HD + 1)
template <int HD>
__device__ __forceinline__ void stage_u(float* u, const float* x,
                                        const float* sdt, size_t row0,
                                        int x_row, int n, int nv) {
  for (int e = threadIdx.x; e < nv * HD; e += THREADS) {
    const int s = e / HD, p = e % HD;
    u[s * (HD + 1) + p] = sdt[s] * x[(row0 + s) * x_row + (size_t)n * HD + p];
  }
}

// Rows [0, n) of a (rows, ds) slab with row stride `stride` into dst (row
// stride DS + 1); rows n..TILE-1 become zeros.
template <int DS>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           size_t stride, int n) {
  for (int e = threadIdx.x; e < TILE * DS; e += THREADS) {
    const int s = e / DS, d = e % DS;
    dst[s * (DS + 1) + d] = s < n ? src[(size_t)s * stride + d] : 0.f;
  }
}

// (a): dh_c of one head, each thread a micro-tile of the (hd, ds) state.
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_states_fma(const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const float* __restrict__ Bm,
                         float* __restrict__ states, float* __restrict__ lq,
                         int S, int nh, int chunk, int x_row, int b_row) {
  constexpr int DSP = DS + 1, HDP = HD + 1;
  // state micro-tile: DX threads along ds, PY along hd
  constexpr int DX = DS < 16 ? DS : 16;
  constexpr int PY = (THREADS / DX) < HD ? THREADS / DX : HD;
  constexpr int SI = HD / PY, SJ = DS / DX;
  static_assert(HD % PY == 0 && DS % DX == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u = reinterpret_cast<float*>(smem_raw);  // chunk x HDP
  float* bt = u + chunk * HDP;                      // TILE x DSP
  float* L = bt + TILE * DSP;                       // r16(chunk)
  float* sdt = L + r16(chunk);                      // r16(chunk)
  float* rem = sdt + r16(chunk);                    // chunk

  launch_dependents();
  const int c = blockIdx.x, n = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = gridDim.x, nv = min(chunk, S - c * chunk);
  const int sx = tid % DX, sy = tid / DX;
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;
  chunk_decays(dt, A, row0, nh, n, 1, 1, nv, r16(chunk), sdt, L);
  const float l_last = L[nv - 1];
  if (tid < nv) rem[tid] = decay(l_last - L[tid]);
  stage_u<HD>(u, x, sdt, row0, x_row, n, nv);

  float dst[SI][SJ];
#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) dst[i][j] = 0.f;
  for (int s0 = 0; s0 < nv; s0 += TILE) {
    const int ns = min(TILE, nv - s0);
    __syncthreads();  // u and rem written; the last tile is done with bt
    stage_tile<DS>(bt, Bm + (row0 + s0) * b_row, b_row, ns);
    __syncthreads();
    if (sy < PY) {
      for (int s = 0; s < ns; ++s) {
        const float r = rem[s0 + s];
        float uv[SI], bv[SJ];
#pragma unroll
        for (int i = 0; i < SI; ++i)
          uv[i] = r * u[(s0 + s) * HDP + sy + PY * i];
#pragma unroll
        for (int j = 0; j < SJ; ++j) bv[j] = bt[s * DSP + sx + DX * j];
#pragma unroll
        for (int i = 0; i < SI; ++i)
#pragma unroll
          for (int j = 0; j < SJ; ++j) dst[i][j] += uv[i] * bv[j];
      }
    }
  }
  const size_t slot = ((size_t)b * nc + c) * nh + n;
  if (sy < PY) {
    float* out = states + slot * HD * DS;
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        out[(sy + PY * i) * DS + sx + DX * j] = dst[i][j];
  }
  if (tid == 0) lq[slot] = l_last;
}

// (c): y of one head over one chunk, from the state entering it.  Per
// 64-row t-tile the carried-state term from the C tile and the state, and
// per causal 64-row s-tile the weights (C_t.B_s) exp(L_t - L_s) into
// shared memory and their product with u, each thread a 4-row register
// micro-tile.  Shared memory row strides are padded by one float against
// bank conflicts.
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_scan_fma(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ states,
                       float* __restrict__ y, int S, int nh, int chunk,
                       int x_row, int b_row, int c_row) {
  constexpr int DSP = DS + 1, HDP = HD + 1;
  constexpr int CJ = HD / 16;  // y columns per thread (16 x 16 layout)
  static_assert(HD % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h = reinterpret_cast<float*>(smem_raw);  // HD x DSP
  float* u = h + HD * DSP;                          // chunk x HDP
  float* ct = u + chunk * HDP;                      // TILE x DSP
  float* bt = ct + TILE * DSP;                      // TILE x DSP
  float* w = bt + TILE * DSP;                       // TILE x WP
  float* L = w + TILE * WP;                         // r16(chunk)
  float* sdt = L + r16(chunk);                      // r16(chunk)

  const int c = blockIdx.x, n = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = gridDim.x, nv = min(chunk, S - c * chunk);
  const int ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;
  chunk_decays(dt, A, row0, nh, n, 1, 1, nv, r16(chunk), sdt, L);
  stage_u<HD>(u, x, sdt, row0, x_row, n, nv);
  wait_for_predecessor();  // the state pass has written slot c
  const float* hin = states + (((size_t)b * nc + c) * nh + n) * HD * DS;
  for (int e = tid; e < HD * DS; e += THREADS)
    h[(e / DS) * DSP + e % DS] = hin[e];

  for (int t0 = 0; t0 < nv; t0 += TILE) {
    const int nt = min(TILE, nv - t0);
    __syncthreads();  // u and h written; the last tile is done with ct
    stage_tile<DS>(ct, Cm + (row0 + t0) * c_row, c_row, nt);
    __syncthreads();
    float acc[4][CJ];
    // the carried state: (C_t . h) exp(L_t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DS; ++d) {
      float cv[4], hv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = ct[(ty + 16 * i) * DSP + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) hv[j] = h[(tx + 16 * j) * DSP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] += cv[i] * hv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      const float e = t < nt ? decay(L[t0 + t]) : 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= e;
    }
    // the quadratic form over the causal s-tiles s0 <= t0
    for (int s0 = 0; s0 <= t0; s0 += TILE) {
      const int ns = min(TILE, nv - s0);
      __syncthreads();  // the last s-tile is done with bt and w
      stage_tile<DS>(bt, Bm + (row0 + s0) * b_row, b_row, ns);
      __syncthreads();
      float wv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DS; ++d) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ct[(ty + 16 * i) * DSP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bt[(tx + 16 * j) * DSP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ti = ty + 16 * i, sj = tx + 16 * j;
          const int t = t0 + ti, s = s0 + sj;
          w[ti * WP + sj] = (ti < nt && sj < ns && s <= t)
                                ? wv[i][j] * decay(L[t] - L[s])
                                : 0.f;
        }
      __syncthreads();
      const int s_end = min(ns, t0 + nt - s0);  // no s past the last t
      for (int s = 0; s < s_end; ++s) {
        float uv[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) uv[j] = u[(s0 + s) * HDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wt = w[(ty + 16 * i) * WP + s];
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] += wt * uv[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t < nt) {
        float* yrow = y + ((row0 + t0 + t) * nh + n) * HD;
#pragma unroll
        for (int j = 0; j < CJ; ++j) yrow[tx + 16 * j] = acc[i][j];
      }
    }
  }
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16 inputs: launches (a) and (c) on tensor cores, a block of heads per CTA
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TT = 128;  // rows of a t-tile of launch (c): 8 slabs of 16

template <int HD, int DS>
struct Shape {
  static constexpr int DSK = DS < 16 ? 16 : DS;  // k depth of C.B^T, C.h^T
  static constexpr int CP = DSK + 8;  // bf16 row pitch of B and C tiles
  static constexpr int XP = HD + 8;   // bf16 row pitch of x tiles
  static constexpr int HP = DSK + 8;  // float row pitch of the state tile
  // (rows 16 bytes apart in banks: conflict-free ldmatrix and float2 loads)
};

// Launch (a)'s shared memory: B rows; C rows, then (d_state 64 and up) a
// head's dh_c on its way out (``out_bytes``); L and the weights of the
// block's heads; nbuf x tiles.
template <int HD, int DS>
__host__ __device__ constexpr int out_bytes(int chunk) {
  return DS < 64 || r16(chunk) * Shape<HD, DS>::CP * 2 > HD * (DS + 8) * 4
             ? r16(chunk) * Shape<HD, DS>::CP * 2
             : HD * (DS + 8) * 4;
}
template <int HD, int DS>
__host__ __device__ constexpr int states_bytes(int chunk, int heads,
                                               int nbuf) {
  using S = Shape<HD, DS>;
  return r16(chunk) * (S::CP * 2 + 2 * heads * 4 + nbuf * S::XP * 2) +
         out_bytes<HD, DS>(chunk);
}

// C.B^T of a chunk in n8 tiles of mma fragments: slab i (rows 16i .. 16i +
// 15) keeps columns 0 .. 16i + 15, 2i + 2 tiles, from tile i (i + 1) on.
__host__ __device__ constexpr int chunk_tiles(int chunk) {
  return (chunk + 15) / 16 * ((chunk + 15) / 16 + 1);
}

// n8 tiles of C.B^T launch (c) keeps for its largest t-tile: the slabs i
// of the t-tile whose first slab is a, at offset i (i + 1) - a (a + 1).
__host__ __device__ constexpr int cb_tiles(int chunk) {
  int best = 0;
  const int n_sl = (chunk + 15) / 16;
  for (int a = 0; a < n_sl; a += TT / 16) {
    const int e = n_sl < a + TT / 16 ? n_sl : a + TT / 16;
    best = best > e * (e + 1) - a * (a + 1) ? best : e * (e + 1) - a * (a + 1);
  }
  return best;
}

// Launch (c)'s shared memory: the C tile, C.B^T, L and dt of the block's
// heads, nbuf x (x tile, state tile).
template <int HD, int DS>
__host__ __device__ constexpr int scan_buffer_bytes(int chunk) {
  using S = Shape<HD, DS>;
  return r16(chunk) * S::XP * 2 + HD * S::HP * 4;
}
template <int HD, int DS>
__host__ __device__ constexpr int scan_bytes(int chunk, int heads, int nbuf) {
  using S = Shape<HD, DS>;
  return TT * S::CP * 2 + cb_tiles(chunk) * 128 * 4 +
         2 * heads * r16(chunk) * 4 + nbuf * scan_buffer_bytes<HD, DS>(chunk);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two k-adjacent float32 values as two bf16 operands: hi = bf16(v), lo =
// bf16(v - hi); hi + lo is v to 2^-16 of v (bf16 keeps 8 bits).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// ... as three: hi, then the rest split as above; to 2^-24 of v.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  split2(a - hf.x, b - hf.y, mid, lo);
}

// The bf16 pair in `v` times (r.x, r.y), split hi/lo.
__device__ __forceinline__ void scale_split(uint32_t v, float2 r,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  split2(f.x * r.x, f.y * r.y, hi, lo);
}

// Rows [0, n) of a (rows, W) bf16 slab with row stride `stride` (elements)
// into dst (row pitch P); rows n .. n_pad - 1 and columns W .. WZ - 1 of
// rows 0 .. n_pad - 1 become zeros.  16-byte cp.async when `vec` (source
// and stride 16-byte aligned; the caller commits and waits), else element
// by element.
template <int W, int WZ, int P>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int n, int n_pad,
                                           bool vec) {
  constexpr int V = W / 8;  // 16-byte vectors per row
  if (vec) {
    for (int e = threadIdx.x; e < n_pad * V; e += THREADS) {
      const int r = e / V, v = e % V;
      const bool ok = r < n;
      cp_async16(dst + r * P + v * 8,
                 src + (size_t)(ok ? r : 0) * stride + v * 8, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n_pad * W; e += THREADS) {
      const int r = e / W, c = e % W;
      dst[r * P + c] = r < n ? src[(size_t)r * stride + c]
                             : __float2bfloat16(0.f);
    }
  }
  if (WZ > W) {
    for (int e = threadIdx.x; e < n_pad * (WZ - W); e += THREADS)
      dst[(e / (WZ - W)) * P + W + e % (WZ - W)] = __float2bfloat16(0.f);
  }
}

// Two bf16 of shared memory as floats.
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// (a): dh_c of each head of the block.  Warp w takes the 16 hd rows mi = w
// % (HD / 16) and a run of the ds columns' n8 tiles; k runs over the
// chunk's rows, 16 at a time.  The CTAs of a chunk also share out its
// C.B^T (``chunk_tiles``) for launch (c).
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_states_mma(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm,
                         float* __restrict__ states, float* __restrict__ lq,
                         float* __restrict__ cb, int S, int nh, int chunk,
                         int x_row, int b_row, int c_row, int heads, int nbuf,
                         int vec) {
  using Sh = Shape<HD, DS>;
  constexpr int CP = Sh::CP, XP = Sh::XP;
  constexpr int MT = HD / 16, NT = DS / 8;
  constexpr int GROUPS = WARPS / MT;                // warps sharing an mi
  constexpr int NTW = (NT + GROUPS - 1) / GROUPS;   // n8 tiles a warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  launch_dependents();  // the state pass may be scheduled
  // heads n0 + j hstep, j < nbh <= heads: the CTAs of a chunk take heads in
  // turn, so at each step they read neighbouring heads of the same rows
  const int c = blockIdx.x, n0 = blockIdx.y, hstep = gridDim.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const int nbh = (nh - n0 + hstep - 1) / hstep;
  const int nv = min(chunk, S - c * chunk), n16 = r16(nv), q16 = r16(chunk);
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);              // q16 x CP
  bf16* Cs = Bs + q16 * CP;  // q16 x CP; then dh_c, HD x (DS + 8) floats
  float* O = reinterpret_cast<float*>(Cs);
  float* L = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Cs) +
                                      out_bytes<HD, DS>(chunk));  // heads x q16
  float* R = L + heads * q16;  // heads x q16: dt, then exp(L_Q - L_s) dt_s
  bf16* Xs = reinterpret_cast<bf16*>(R + heads * q16);       // nbuf x q16 x XP
  const bf16* xb = x + row0 * x_row + (size_t)n0 * HD;

  stage_rows<DS, DS, CP>(Bs, Bm + row0 * b_row, b_row, nv, n16, vec);
  stage_rows<DS, DS, CP>(Cs, Cm + row0 * c_row, c_row, nv, n16, vec);
  stage_rows<HD, HD, XP>(Xs, xb, x_row, nv, n16, vec);
  cp_async_commit();
  chunk_decays(dt, A, row0, nh, n0, hstep, nbh, nv, q16, R, L);
  for (int j = warp; j < nbh; j += WARPS) {
    const float l_last = L[j * q16 + nv - 1];
    for (int r = lane; r < n16; r += 32)
      R[j * q16 + r] *= decay(l_last - L[j * q16 + r]);
    if (lane == 0) lq[((size_t)b * nc + c) * nh + n0 + j * hstep] = l_last;
  }

  // This CTA's share of the chunk's C.B^T: the units (slab i, 16 columns
  // kp <= i) u with u % gridDim.y == blockIdx.y, a unit a warp, each lane
  // the 8 entries its mma fragments hold, stored in that order.  Float32
  // FMA over d in order, not tensor cores: where C_t.B_s cancels to a small
  // value and carries a row of y, a tensor-core sum's truncation puts the
  // row past the tolerance and this order rounds as the plain version.
  cp_async_wait<0>();
  __syncthreads();
  float* cbc = cb + ((size_t)b * nc + c) * chunk_tiles(chunk) * 128;
  for (int i = 0, u = 0; i < n16 / 16; ++i) {
    for (int kp = 0; kp <= i; ++kp, ++u) {
      if (u % gridDim.y != blockIdx.y || u / gridDim.y % WARPS != warp)
        continue;
      const bf16* c0 = Cs + (16 * i + g) * CP;
      const bf16* bs = Bs + (16 * kp + 2 * t4) * CP;  // rows s, s + 1
      float e[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < DS; d += 2) {
        const float2 ca = ld2(c0 + d), cc = ld2(c0 + 8 * CP + d);
        const float2 b0 = ld2(bs + d), b1 = ld2(bs + CP + d);
        const float2 b8 = ld2(bs + 8 * CP + d), b9 = ld2(bs + 9 * CP + d);
        // tile 2kp: (g, s), (g, s + 1), (g + 8, s), (g + 8, s + 1); tile
        // 2kp + 1 the same 8 columns on
        e[0] = fmaf(ca.y, b0.y, fmaf(ca.x, b0.x, e[0]));
        e[1] = fmaf(ca.y, b1.y, fmaf(ca.x, b1.x, e[1]));
        e[2] = fmaf(cc.y, b0.y, fmaf(cc.x, b0.x, e[2]));
        e[3] = fmaf(cc.y, b1.y, fmaf(cc.x, b1.x, e[3]));
        e[4] = fmaf(ca.y, b8.y, fmaf(ca.x, b8.x, e[4]));
        e[5] = fmaf(ca.y, b9.y, fmaf(ca.x, b9.x, e[5]));
        e[6] = fmaf(cc.y, b8.y, fmaf(cc.x, b8.x, e[6]));
        e[7] = fmaf(cc.y, b9.y, fmaf(cc.x, b9.x, e[7]));
      }
      float* dst = cbc + (i * (i + 1) + 2 * kp) * 128 + lane * 4;
      *reinterpret_cast<float4*>(dst) = make_float4(e[0], e[1], e[2], e[3]);
      *reinterpret_cast<float4*>(dst + 128) =
          make_float4(e[4], e[5], e[6], e[7]);
    }
  }

  const int mi = warp % MT, nt0 = (warp / MT) * NTW;
  for (int j = 0; j < nbh; ++j) {
    const int buf = nbuf == 2 ? j & 1 : 0;
    if (nbuf == 2 && j + 1 < nbh) {
      stage_rows<HD, HD, XP>(Xs + (buf ^ 1) * q16 * XP,
                             xb + (size_t)(j + 1) * hstep * HD,
                             x_row, nv, n16, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x of head j (and, first, B and the weights) in
    const bf16* xs = Xs + buf * q16 * XP;
    const float* r = R + j * q16;
    float acc[NTW][4];
#pragma unroll
    for (int i = 0; i < NTW; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int k0 = 0; k0 < n16; k0 += 16) {
      // A = (x_s exp(L_Q - L_s) dt_s)^T: rows hd, k the chunk's rows
      uint32_t a[4], ahi[4], alo[4];
      ldsm_x4_trans(a, xs + (k0 + lane % 8 + 8 * (lane / 16)) * XP + mi * 16 +
                           8 * ((lane / 8) % 2));
      const float2 r0 = *reinterpret_cast<const float2*>(r + k0 + 2 * t4);
      const float2 r1 = *reinterpret_cast<const float2*>(r + k0 + 8 + 2 * t4);
      scale_split(a[0], r0, ahi[0], alo[0]);
      scale_split(a[1], r0, ahi[1], alo[1]);
      scale_split(a[2], r1, ahi[2], alo[2]);
      scale_split(a[3], r1, ahi[3], alo[3]);
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        if (nt0 + i < NT) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1,
                            Bs + (k0 + lane % 16) * CP + (nt0 + i) * 8);
          mma_bf16(acc[i], ahi, b0, b1);
          mma_bf16(acc[i], alo, b0, b1);
        }
      }
    }
    // dh_c out: rows of 64 or more floats through shared memory, in whole
    // 16-byte pieces (the fragments' 8-byte stores scattered over rows
    // held back the next head's loads at mamba2-130m's d_state 128);
    // narrower rows straight from the fragments
    float* out =
        states + (((size_t)b * nc + c) * nh + n0 + j * hstep) * HD * DS;
    float* o = DS >= 64 ? O : out;
    constexpr int OP = DS >= 64 ? DS + 8 : DS;  // o's row pitch
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      if (nt0 + i < NT) {
        const int p = mi * 16 + g, d = (nt0 + i) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(o + p * OP + d) =
            make_float2(acc[i][0], acc[i][1]);
        *reinterpret_cast<float2*>(o + (p + 8) * OP + d) =
            make_float2(acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();  // the buffer of head j is free (and dh_c staged)
    if (DS >= 64) {
      for (int e = tid; e < HD * DS / 4; e += THREADS)
        reinterpret_cast<float4*>(out)[e] = *reinterpret_cast<const float4*>(
            O + (e / (DS / 4)) * OP + e % (DS / 4) * 4);
    }
    if (nbuf == 1 && j + 1 < nbh) {
      stage_rows<HD, HD, XP>(Xs, xb + (size_t)(j + 1) * hstep * HD, x_row,
                             nv, n16, vec);
      cp_async_commit();
    }
  }
}

// (c): y of each head of the block over one chunk.
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_scan_mma(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ cb,
                       const float* __restrict__ states,
                       float* __restrict__ y, int S, int nh, int chunk,
                       int x_row, int c_row, int heads, int nbuf, int vec) {
  using Sh = Shape<HD, DS>;
  constexpr int DSK = Sh::DSK, CP = Sh::CP, XP = Sh::XP, HP = Sh::HP;
  constexpr int NT8 = HD / 8;  // n8 tiles of the head dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // heads n0 + j hstep, j < nbh <= heads, as in launch (a)
  const int c = blockIdx.x, n0 = blockIdx.y, hstep = gridDim.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const int nbh = (nh - n0 + hstep - 1) / hstep;
  const int nv = min(chunk, S - c * chunk), q16 = r16(chunk);
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);            // TT x CP
  float* CB = reinterpret_cast<float*>(Cs + TT * CP);       // tiles x 128
  float* L = CB + cb_tiles(chunk) * 128;                    // heads x q16
  float* DT = L + heads * q16;                              // heads x q16
  unsigned char* U = reinterpret_cast<unsigned char*>(DT + heads * q16);
  const int buf_bytes = scan_buffer_bytes<HD, DS>(chunk);
  auto xs_of = [&](int buf) {
    return reinterpret_cast<bf16*>(U + buf * buf_bytes);
  };
  auto hs_of = [&](int buf) {
    return reinterpret_cast<float*>(U + buf * buf_bytes + q16 * XP * 2);
  };
  const bf16* xb = x + row0 * x_row + (size_t)n0 * HD;
  const float* hb = states + (((size_t)b * nc + c) * nh + n0) * HD * DS;
  const float* cbc = cb + ((size_t)b * nc + c) * chunk_tiles(chunk) * 128;

  // x rows [0, n) of head j and its incoming state into buffer buf
  auto stage_x = [&](int j, int buf, int n, int n_pad) {
    stage_rows<HD, HD, XP>(xs_of(buf), xb + (size_t)j * hstep * HD, x_row, n,
                           n_pad, vec);
  };
  auto stage_h = [&](int j, int buf) {
    float* hs = hs_of(buf);
    const float* src = hb + (size_t)j * hstep * HD * DS;
    for (int e = tid; e < HD * DS / 4; e += THREADS) {
      const int p = e / (DS / 4), v = e % (DS / 4);
      cp_async16(hs + p * HP + v * 4, src + p * DS + v * 4);
    }
    if (DSK > DS) {
      for (int e = tid; e < HD * (DSK - DS); e += THREADS)
        hs[(e / (DSK - DS)) * HP + DS + e % (DSK - DS)] = 0.f;
    }
  };

  chunk_decays(dt, A, row0, nh, n0, hstep, nbh, nv, q16, DT, L);
  bool waited = false;
  for (int t0 = 0; t0 < nv; t0 += TT) {
    const int t_end = min(nv, t0 + TT), e16 = r16(t_end);
    const int sl0 = t0 / 16, sl1 = e16 / 16;  // the tile's slabs
    const int base = sl0 * (sl0 + 1);         // C.B^T tile offset of sl0
    __syncthreads();  // the last t-tile is done with Cs and U
    stage_rows<DS, DSK, CP>(Cs, Cm + (row0 + t0) * c_row, c_row, t_end - t0,
                            e16 - t0, vec);
    stage_x(0, 0, t_end, e16);
    cp_async_commit();
    if (!waited) {
      // the state pass has written the slots (and launch (a) C.B^T)
      wait_for_predecessor();
      waited = true;
    }
    // C.B^T of the tile's slabs, in the fragment order launch (a) left
    for (int e = tid; e < (sl1 * (sl1 + 1) - base) * 32; e += THREADS)
      cp_async16(CB + e * 4, cbc + base * 128 + e * 4);
    stage_h(0, 0);
    cp_async_commit();

    for (int j = 0; j < nbh; ++j) {
      const int buf = nbuf == 2 ? j & 1 : 0;
      if (nbuf == 2 && j + 1 < nbh) {
        stage_x(j + 1, buf ^ 1, t_end, e16);
        stage_h(j + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // x and the state of head j in
      const bf16* xs = xs_of(buf);
      const float* hs = hs_of(buf);
      const float* Lj = L + j * q16;
      const float* Dj = DT + j * q16;
      const int i = sl0 + warp;  // the warp's slab
      if (i < sl1) {
        const int ta = i * 16 + g, tb = ta + 8;  // the thread's rows
        const bf16* crow =
            Cs + ((i - sl0) * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * CP +
            8 * (lane / 16);
        float acc[NT8][4];
#pragma unroll
        for (int q = 0; q < NT8; ++q)
          acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
        // the carried state: (C_t . h) exp(L_t)
#pragma unroll
        for (int k0 = 0; k0 < DSK; k0 += 16) {
          uint32_t a[4];
          ldsm_x4(a, crow + k0);
#pragma unroll
          for (int q = 0; q < NT8; ++q) {
            const float* hp = hs + (q * 8 + g) * HP + k0 + 2 * t4;
            const float2 v0 = *reinterpret_cast<const float2*>(hp);
            const float2 v1 = *reinterpret_cast<const float2*>(hp + 8);
            uint32_t h0, m0, l0, h1, m1, l1;
            split3(v0.x, v0.y, h0, m0, l0);
            split3(v1.x, v1.y, h1, m1, l1);
            mma_bf16(acc[q], a, h0, h1);
            mma_bf16(acc[q], a, m0, m1);
            mma_bf16(acc[q], a, l0, l1);
          }
        }
        const float la = Lj[ta], lb = Lj[tb];
        const float ea = decay(la), eb = decay(lb);
#pragma unroll
        for (int q = 0; q < NT8; ++q) {
          acc[q][0] *= ea;
          acc[q][1] *= ea;
          acc[q][2] *= eb;
          acc[q][3] *= eb;
        }
        // the quadratic form: W = C.B^T o exp(L_t - L_s) o causal, dt_s
        // folded in, times x
        const float* cb = CB + (i * (i + 1) - base) * 128 + lane * 4;
        for (int kp = 0; kp <= i; ++kp) {
          const float4 w0 = *reinterpret_cast<const float4*>(cb + 2 * kp * 128);
          const float4 w1 =
              *reinterpret_cast<const float4*>(cb + (2 * kp + 1) * 128);
          const int s = kp * 16 + 2 * t4;
          const float2 ls0 = *reinterpret_cast<const float2*>(Lj + s);
          const float2 ls1 = *reinterpret_cast<const float2*>(Lj + s + 8);
          const float2 ds0 = *reinterpret_cast<const float2*>(Dj + s);
          const float2 ds1 = *reinterpret_cast<const float2*>(Dj + s + 8);
          float v[8] = {w0.x * fast_decay(la - ls0.x) * ds0.x,
                        w0.y * fast_decay(la - ls0.y) * ds0.y,
                        w0.z * fast_decay(lb - ls0.x) * ds0.x,
                        w0.w * fast_decay(lb - ls0.y) * ds0.y,
                        w1.x * fast_decay(la - ls1.x) * ds1.x,
                        w1.y * fast_decay(la - ls1.y) * ds1.y,
                        w1.z * fast_decay(lb - ls1.x) * ds1.x,
                        w1.w * fast_decay(lb - ls1.y) * ds1.y};
          if (kp == i) {  // the diagonal block: s <= t only
            if (s > ta) v[0] = 0.f;
            if (s + 1 > ta) v[1] = 0.f;
            if (s > tb) v[2] = 0.f;
            if (s + 1 > tb) v[3] = 0.f;
            if (s + 8 > ta) v[4] = 0.f;
            if (s + 9 > ta) v[5] = 0.f;
            if (s + 8 > tb) v[6] = 0.f;
            if (s + 9 > tb) v[7] = 0.f;
          }
          uint32_t ah[4], al[4];
          split2(v[0], v[1], ah[0], al[0]);
          split2(v[2], v[3], ah[1], al[1]);
          split2(v[4], v[5], ah[2], al[2]);
          split2(v[6], v[7], ah[3], al[3]);
          // x of rows 16 kp .. 16 kp + 15, two n8 tiles a load
          const bf16* xrow =
              xs + (kp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * XP +
              8 * (lane / 16);
#pragma unroll
          for (int q = 0; q < NT8; q += 2) {
            uint32_t b[4];
            ldsm_x4_trans(b, xrow + q * 8);
            mma_bf16(acc[q], ah, b[0], b[1]);
            mma_bf16(acc[q], al, b[0], b[1]);
            mma_bf16(acc[q + 1], ah, b[2], b[3]);
            mma_bf16(acc[q + 1], al, b[2], b[3]);
          }
        }
#pragma unroll
        for (int q = 0; q < NT8; ++q) {
          const int p = q * 8 + 2 * t4;
          if (ta < nv)
            *reinterpret_cast<float2*>(
                y + ((row0 + ta) * nh + n0 + j * hstep) * HD + p) =
                make_float2(acc[q][0], acc[q][1]);
          if (tb < nv)
            *reinterpret_cast<float2*>(
                y + ((row0 + tb) * nh + n0 + j * hstep) * HD + p) =
                make_float2(acc[q][2], acc[q][3]);
        }
      }
      __syncthreads();  // the buffers of head j are free
      if (nbuf == 1 && j + 1 < nbh) {
        stage_x(j + 1, 0, t_end, e16);
        stage_h(j + 1, 0);
        cp_async_commit();
      }
    }
  }
}

}  // namespace tc

// Raise a kernel's shared-memory ceiling to `bytes` once per size seen
// (`allowed`: the largest set so far for this kernel).
template <typename F>
cudaError_t ensure_smem(F* kern, int bytes, int& allowed) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes > allowed) {
    const cudaError_t err = allow_smem(kern, bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  return cudaSuccess;
}

// A programmatic dependent launch of `kern` on `st`: it may start while
// the launch before it on the stream runs, and waits for it inside
// (wait_for_predecessor).
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kern)(Params...), dim3 grid, int smem,
                             cudaStream_t st, Args... args) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *A, *h0;
  float *y, *hout, *states, *lq, *cb;
  int B, S, nh, chunk, x_row, b_row, c_row, heads;
  cudaStream_t st;
};

// Launch (b), then (c) of either path.
cudaError_t state_pass(const Args& a, int hdds) {
  const int nc = (a.S + a.chunk - 1) / a.chunk;
  const long long n4 = (long long)a.B * a.nh * hdds / 4;
  const dim3 grid((unsigned)((n4 + THREADS - 1) / THREADS));
  return launch_pdl(ssd_state_pass, grid, 0, a.st, a.states,
                    (const float*)a.lq, a.h0, a.hout, a.B, nc, a.nh, hdds);
}

template <int HD, int DS>
cudaError_t launch_fma(const Args& a) {
  using namespace fp32;
  const float *x = (const float*)a.x, *Bm = (const float*)a.Bm,
              *Cm = (const float*)a.Cm;
  const int nc = (a.S + a.chunk - 1) / a.chunk;
  const dim3 grid(nc, a.nh, a.B);
  auto* ka = ssd_chunk_states_fma<HD, DS>;
  auto* kc = ssd_chunk_scan_fma<HD, DS>;
  static int allowed_a = 48 << 10, allowed_c = 48 << 10;
  const int smem_a = states_floats(HD, DS, a.chunk) * 4;
  const int smem_c = scan_floats(HD, DS, a.chunk) * 4;
  cudaError_t err = ensure_smem(ka, smem_a, allowed_a);
  if (err == cudaSuccess) err = ensure_smem(kc, smem_c, allowed_c);
  if (err != cudaSuccess) return err;
  ka<<<grid, THREADS, smem_a, a.st>>>(x, a.dt, a.A, Bm, a.states, a.lq, a.S,
                                       a.nh, a.chunk, a.x_row, a.b_row);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = state_pass(a, HD * DS);
  if (err != cudaSuccess) return err;
  return launch_pdl(kc, grid, smem_c, a.st, x, a.dt, a.A, Bm, Cm,
                          (const float*)a.states, a.y, a.S, a.nh, a.chunk,
                          a.x_row, a.b_row, a.c_row);
}

template <int HD, int DS>
cudaError_t launch_mma(const Args& a) {
  using namespace tc;
  using T = __nv_bfloat16;
  const T *x = (const T*)a.x, *Bm = (const T*)a.Bm, *Cm = (const T*)a.Cm;
  if (a.heads < 1) return cudaErrorInvalidValue;
  const int nc = (a.S + a.chunk - 1) / a.chunk;
  const dim3 grid(nc, (a.nh + a.heads - 1) / a.heads, a.B);
  // 16-byte copies when every row of x, B and C starts 16-byte aligned
  const int vec = ((uintptr_t)a.x | (uintptr_t)a.Bm | (uintptr_t)a.Cm) % 16 ==
                      0 &&
                  (a.x_row | a.b_row | a.c_row) % 8 == 0;
  // two buffers (the next head's loads beside this head's products) where
  // they fit
  const int nbuf_a =
      states_bytes<HD, DS>(a.chunk, a.heads, 2) <= MAX_SMEM ? 2 : 1;
  const int nbuf_c =
      scan_bytes<HD, DS>(a.chunk, a.heads, 2) <= MAX_SMEM ? 2 : 1;
  const int smem_a = states_bytes<HD, DS>(a.chunk, a.heads, nbuf_a);
  const int smem_c = scan_bytes<HD, DS>(a.chunk, a.heads, nbuf_c);
  auto* ka = ssd_chunk_states_mma<HD, DS>;
  auto* kc = ssd_chunk_scan_mma<HD, DS>;
  static int allowed_a = 48 << 10, allowed_c = 48 << 10;
  cudaError_t err = ensure_smem(ka, smem_a, allowed_a);
  if (err == cudaSuccess) err = ensure_smem(kc, smem_c, allowed_c);
  if (err != cudaSuccess) return err;
  ka<<<grid, THREADS, smem_a, a.st>>>(x, a.dt, a.A, Bm, Cm, a.states, a.lq,
                                       a.cb, a.S, a.nh, a.chunk, a.x_row,
                                       a.b_row, a.c_row, a.heads, nbuf_a,
                                       vec);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = state_pass(a, HD * DS);
  if (err != cudaSuccess) return err;
  return launch_pdl(kc, grid, smem_c, a.st, x, a.dt, a.A, Cm,
                          (const float*)a.cb, (const float*)a.states, a.y,
                          a.S, a.nh, a.chunk, a.x_row, a.c_row, a.heads,
                          nbuf_c, vec);
}

template <int HD, int DS>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == DTYPE_F32) return launch_fma<HD, DS>(a);
  if (dtype == DTYPE_BF16) return launch_mma<HD, DS>(a);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t dispatch_ds(int ds, int dtype, const Args& a) {
  switch (ds) {
    case 8: return launch<HD, 8>(dtype, a);
    case 16: return launch<HD, 16>(dtype, a);
    case 32: return launch<HD, 32>(dtype, a);
    case 64: return launch<HD, 64>(dtype, a);
    case 128: return launch<HD, 128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x/Bm/Cm in `dtype` (DTYPE_F32 or DTYPE_BF16) with row strides x_row,
// b_row, c_row (elements); dt, A, h0 (nullable), y, hout f32; states (B,
// nc, nh, hd, ds) and lq (B, nc, nh) f32 scratch, nc = ceil(S / chunk),
// and in bf16 cb, (B, nc, chunk_tiles(chunk) x 128) f32 scratch for C.B^T
// (float32 takes none).
// hd in {16, 32, 64}, ds in {8, 16, 32, 64, 128}, 1 <= chunk <= 256; in
// bf16 `heads` >= 1 heads share a CTA of launches (a) and (c) (float32:
// one, whatever `heads` says).  Three launches on `stream`; returns the
// first error.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0,
                        void* y, void* hout, void* states, void* lq, void* cb,
                        int B,
                        int S, int nh, int hd, int ds, int chunk, int x_row,
                        int b_row, int c_row, int heads, int dtype,
                        void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || S < 1 || B < 1 || nh < 1)
    return cudaErrorInvalidValue;
  const Args a{x, Bm, Cm, (const float*)dt, (const float*)A,
               (const float*)h0, (float*)y, (float*)hout, (float*)states,
               (float*)lq, (float*)cb, B, S, nh, chunk, x_row, b_row, c_row,
               heads,
               (cudaStream_t)stream};
  switch (hd) {
    case 16: return dispatch_ds<16>(ds, dtype, a);
    case 32: return dispatch_ds<32>(ds, dtype, a);
    case 64: return dispatch_ds<64>(ds, dtype, a);
    default: return cudaErrorInvalidValue;
  }
}
