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
// they add nothing and leave the state unchanged): the kernel runs only
// the chunk's real rows and takes L_Q at its last real row.
//
// Replaces: src/repro/kernels/ssd_scan.py:75, ssd_scan_pallas (pallas_call
// at :99), which asserts S % chunk == 0 and nh % block_nh == 0 (block_nh
// 8); hymba-1.5b's 50 heads and lookaheadkv's 32-row observation segment
// fail those on a TPU.  This kernel takes any S >= 1, any nh and any
// chunk of 1..256 rows.
//
// Layout: x (B, S, nh, hd) with row stride x_row between consecutive (b,
// s) and batch stride S * x_row; B/C (B, S, 1, ds) with row strides b_row /
// c_row (the model passes views of its conv output); dt (B, S, nh) f32;
// A (nh,) f32; initial state (B, nh, hd, ds) f32 or null (zeros).  Outputs
// y (B, S, nh, hd) f32 and the final state (B, nh, hd, ds) f32.  x/B/C are
// bf16 or f32; all arithmetic is f32 (as in the Pallas kernel).
//
// Design: the TPU grid's sequential chunk axis becomes a loop inside one
// CTA per (head, batch), so the state never leaves shared memory between
// chunks.  Per chunk: the log-decays' prefix sum (a warp-shuffle block
// scan), u = dt x staged once in shared memory, then per 64-row t-tile
// the carried-state term from the C tile and the state, and per causal
// 64-row s-tile the weights (C_t.B_s) exp(L_t - L_s) into shared memory
// and their product with u, each thread a 4-row register micro-tile; at
// the chunk's end each thread updates its own register micro-tile of the
// state from the B tiles.  Shared memory row strides are padded by one
// float against bank conflicts.
//
// Bound on the H100: bandwidth.  Each input is read once and each output
// written once: x (bf16), y (f32) and the states dominate (hymba-1.5b's
// lockstep prefill, B 4 x S 2048 x 50 heads x 64: ~160 MB, ~0.048 ms);
// the ~2 S Q (ds + hd) nh B operations of the quadratic form are below
// the byte time on tensor cores but not on float32 CUDA cores.  What this
// design leaves on the table: float32 CUDA cores only (no tensor cores),
// C.B^T recomputed by every head (it is shared, ngroups = 1), B and C tiles
// re-read from L2 per (t, s) tile pair, one CTA per (head, batch) (96 CTAs
// at mamba2-130m's shape, under one wave), no overlap of loads with math.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;        // rows of a t- or s-tile inside a chunk
constexpr int MAX_CHUNK = 256;  // one row of the prefix sum per thread
constexpr int WP = TILE + 1;    // row stride of the weight tile

__device__ __forceinline__ float decay(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
}

// Shared memory of one CTA, in floats.
__host__ __device__ constexpr int smem_floats(int hd, int ds, int chunk) {
  return hd * (ds + 1)          // state h
         + chunk * (hd + 1)     // u = dt x of the chunk
         + 2 * TILE * (ds + 1)  // C rows of the t-tile, B rows of the s-tile
         + TILE * WP            // weights of the (t, s) pairs
         + 3 * chunk            // L, dt, exp(L_Q - L_s)
         + THREADS / 32;        // warp totals of the prefix sum
}

// Stage rows [0, n) of a (rows, ds) slab with row stride `stride` as f32
// into dst (row stride ds + 1); rows n..TILE-1 become zeros.
template <typename T, int DS>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           size_t stride, int n) {
  for (int e = threadIdx.x; e < TILE * DS; e += THREADS) {
    const int s = e / DS, d = e % DS;
    dst[s * (DS + 1) + d] = s < n ? to_f32(src[(size_t)s * stride + d]) : 0.f;
  }
}

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ hout, int S,
                    int nh, int chunk, int x_row, int b_row, int c_row) {
  constexpr int DSP = DS + 1, HDP = HD + 1;
  constexpr int CJ = HD / 16;  // y columns per thread (16 x 16 layout)
  // state micro-tile: DX threads along ds, PY along hd
  constexpr int DX = DS < 16 ? DS : 16;
  constexpr int PY = (THREADS / DX) < HD ? THREADS / DX : HD;
  constexpr int SI = HD / PY, SJ = DS / DX;
  static_assert(HD % 16 == 0 && HD % PY == 0 && DS % DX == 0, "tile shape");

  extern __shared__ float smem[];
  float* h = smem;                    // HD x DSP
  float* u = h + HD * DSP;            // chunk x HDP
  float* ct = u + chunk * HDP;        // TILE x DSP
  float* bt = ct + TILE * DSP;        // TILE x DSP
  float* w = bt + TILE * DSP;         // TILE x WP
  float* L = w + TILE * WP;           // chunk
  float* sdt = L + chunk;             // chunk
  float* rem = sdt + chunk;           // chunk
  float* wsum = rem + chunk;          // THREADS / 32

  const int n = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;
  const int sx = tid % DX, sy = tid / DX;
  const bool s_owner = sy < PY;  // threads holding a state micro-tile
  const float a_n = A[n];
  const size_t head_state = ((size_t)b * nh + n) * HD * DS;

  for (int e = tid; e < HD * DS; e += THREADS) {
    const int p = e / DS, d = e % DS;
    h[p * DSP + d] = h0 != nullptr ? h0[head_state + e] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int nv = min(chunk, S - c0);  // real rows of this chunk
    const size_t row0 = (size_t)b * S + c0;
    __syncthreads();  // the last chunk is done with L, u and the state

    // (1) log-decays a_s = A dt_s and their inclusive prefix sum L
    float dtv = 0.f;
    if (tid < nv) dtv = dt[(row0 + tid) * nh + n];
    float v = a_n * dtv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int i = 0; i < warp; ++i) v += wsum[i];
    if (tid < nv) {
      L[tid] = v;
      sdt[tid] = dtv;
    }
    __syncthreads();
    const float l_last = L[nv - 1];
    if (tid < nv) rem[tid] = decay(l_last - L[tid]);
    // (2) u = dt x for the chunk's rows
    for (int e = tid; e < nv * HD; e += THREADS) {
      const int s = e / HD, p = e % HD;
      u[s * HDP + p] =
          sdt[s] * to_f32(x[(row0 + s) * x_row + (size_t)n * HD + p]);
    }

    // (3) y, one 64-row t-tile at a time
    for (int t0 = 0; t0 < nv; t0 += TILE) {
      const int nt = min(TILE, nv - t0);
      __syncthreads();  // u and rem written; the last tile is done with ct
      stage_tile<T, DS>(ct, Cm + (row0 + t0) * c_row, c_row, nt);
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
        stage_tile<T, DS>(bt, Bm + (row0 + s0) * b_row, b_row, ns);
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

    // (4) h <- exp(L_Q) h + sum_s exp(L_Q - L_s) u_s (x) B_s
    float dst[SI][SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) dst[i][j] = 0.f;
    for (int s0 = 0; s0 < nv; s0 += TILE) {
      const int ns = min(TILE, nv - s0);
      __syncthreads();  // y is done with bt (and with h)
      stage_tile<T, DS>(bt, Bm + (row0 + s0) * b_row, b_row, ns);
      __syncthreads();
      if (s_owner) {
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
    if (s_owner) {
      const float eq = decay(l_last);
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          float* hp = h + (sy + PY * i) * DSP + sx + DX * j;
          *hp = *hp * eq + dst[i][j];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < HD * DS; e += THREADS) {
    const int p = e / DS, d = e % DS;
    hout[head_state + e] = h[p * DSP + d];
  }
}

template <typename T, int HD, int DS>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* h0, float* y,
                   float* hout, int B, int S, int nh, int chunk, int x_row,
                   int b_row, int c_row, cudaStream_t st) {
  if (chunk < 1 || chunk > MAX_CHUNK || S < 1 || B < 1 || nh < 1)
    return cudaErrorInvalidValue;
  const int bytes = smem_floats(HD, DS, chunk) * (int)sizeof(float);
  auto* kern = ssd_scan_kernel<T, HD, DS>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nh, B), THREADS, bytes, st>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, h0, y, hout, S, nh,
      chunk, x_row, b_row, c_row);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_ds(int ds, const void* x, const float* dt,
                        const float* A, const void* Bm, const void* Cm,
                        const float* h0, float* y, float* hout, int B, int S,
                        int nh, int chunk, int x_row, int b_row, int c_row,
                        cudaStream_t st) {
#define SSD_DS(D)                                                          \
  case D:                                                                  \
    return launch<T, HD, D>(x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, \
                            x_row, b_row, c_row, st);
  switch (ds) {
    SSD_DS(8)
    SSD_DS(16)
    SSD_DS(32)
    SSD_DS(64)
    SSD_DS(128)
    default: return cudaErrorInvalidValue;
  }
#undef SSD_DS
}

template <typename T>
cudaError_t dispatch_hd(int hd, int ds, const void* x, const float* dt,
                        const float* A, const void* Bm, const void* Cm,
                        const float* h0, float* y, float* hout, int B, int S,
                        int nh, int chunk, int x_row, int b_row, int c_row,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_ds<T, 16>(ds, x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, x_row, b_row, c_row, st);
    case 32: return dispatch_ds<T, 32>(ds, x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, x_row, b_row, c_row, st);
    case 64: return dispatch_ds<T, 64>(ds, x, dt, A, Bm, Cm, h0, y, hout, B, S, nh, chunk, x_row, b_row, c_row, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x/Bm/Cm in `dtype` (DTYPE_F32 or DTYPE_BF16) with row strides x_row,
// b_row, c_row (elements); dt, A, h0 (nullable), y, hout f32.  hd in {16,
// 32, 64}, ds in {8, 16, 32, 64, 128}, 1 <= chunk <= 256.  Returns
// cudaGetLastError() after launch.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0,
                        void* y, void* hout, int B, int S, int nh, int hd,
                        int ds, int chunk, int x_row, int b_row, int c_row,
                        int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dtf = (const float*)dt, *Af = (const float*)A,
              *h0f = (const float*)h0;
  float *yf = (float*)y, *hf = (float*)hout;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, ds, x, dtf, Af, Bm, Cm, h0f, yf, hf, B, S, nh, chunk, x_row, b_row, c_row, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, ds, x, dtf, Af, Bm, Cm, h0f, yf, hf, B, S, nh, chunk, x_row, b_row, c_row, st);
  return cudaErrorInvalidValue;
}
