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
// TPU kernel becomes two launches on the same stream: (a) row statistics,
// each CTA streaming a share (a key split) of the keys its rows see and
// writing each row's partial (m, l) to a float32 scratch (B, H, n_split,
// n_obs); (b) column means, one CTA per 64-key tile merging the partials
// into each row's final (m, l) in split order, recomputing its tile's
// logits, and summing exp(s - m) / l over the rows.  Tiles past the last
// visible key (q_offset + n_obs - 1) write exact zeros without reading K.
// Layout: q_obs (B, n_obs, H, hd), k (B, Sk, KV, hd) contiguous.
//
// bf16 (namespace tc): tensor cores, the GQA group packed into one tile.
// A CTA takes all G query heads of one kv head over a block of
// observation rows: each head's rows are padded to 16, and a row block is
// 8 such 16-row fragments in (row fragment, head) order (llama3-8b's 4
// heads x 32 rows are one block of 128 packed rows), so each K tile in
// shared memory serves the whole group.  S = Q K^T runs on mma.sync
// m16n8k16 (bf16 operands from ldmatrix on padded rows, float32
// accumulators), 4 warps of two fragments each, K tiles through a 3-stage
// cp.async ring in (a); logits are in base 2 (scale * log2 e folded in,
// ex2.approx), the softmax arithmetic float32.  Only the tiles on a
// boundary (the causal diagonal, a window's edge, the ragged key tail, a
// kv_mask) test each (row, key); the others, all but one of llama3-8b's
// 63 at the finalize, take every pair unmasked.  Launch (a): grid (n_split x row
// blocks, KV, B), the online (m, l) of each packed row in registers,
// reduced over a fragment's quad by shuffles.  Launch (b): grid (key
// tiles, KV, B); K staged once; per row block (a 2-stage cp.async ring of
// the packed Q rows and the raw partials) the partials merged once per
// row into (m, 1 / max(l, 1e-30)), the logits recomputed by the same MMA
// calls in the same order as (a), and the weights summed over each head's
// rows: within a fragment by shuffles, across fragments and row blocks
// through shared memory in a fixed order (deterministic, no atomics).
// (b) is a programmatic dependent launch: it starts while (a) runs,
// stages its K tiles and Q rows, and waits for (a) only before it reads
// the partials.
//
// float32 (namespace fp32): a tensor-core product of float32 inputs would
// round them to TF32, far outside the 2^-16 tolerance, so float32 keeps
// scalar FMAs over operands widened in shared memory: one CTA per (row
// tile of 32, head), the (m, l) scratch in natural units.
//
// Bound on the H100: bandwidth, the bytes of q_obs, the visible key rows
// (each read once) and the output over 3.35 TB/s (~2.7 us at llama3-8b's
// 32 rows over 4096 keys).  The bf16 MMAs (~1 GFLOP a launch there) take
// well under that, so a call is bound by its two launches and the round
// trips inside them (the first K tile, the partials in (b)).  What this
// design leaves on the table: K is read twice and the logits computed
// twice, once per launch; a thread-block cluster holding a kv head's key
// splits could merge the (m, l) through distributed shared memory and
// emit the column means in one launch, reading K once.
#include "common.cuh"

namespace {

namespace fp32 {

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


}  // namespace fp32

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;             // keys per tile
constexpr int NF = BK / 8;         // n8 fragments of S per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int FPW = 2;             // 16-row fragments per warp
constexpr int MAXF = WARPS * FPW;  // fragments per row block
constexpr int ROWS = 16 * MAXF;    // packed rows per row block
constexpr int NST = 3;             // K ring stages of launch (a)
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA may take
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS >= ROWS, "launch (b) merges one packed row a thread");

// 2^x on the special-function unit, results below 2^-126 flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Shape {
  static constexpr int LD = HD + 8;   // halves per shared row (conflict-free
                                      // ldmatrix: rows 16 bytes apart in banks)
  static constexpr int KS = HD / 16;  // k-steps of the product
  static constexpr int CH = HD / 8;   // 16-byte chunks per row
};

// Row block rb of one kv head's packed rows: fragments [f0, f1) of the
// (row fragment j, head g) order, fragment f = 16 rows from 16 (f / G) of
// query head kvh * G + f % G, rows past n_obs padding; its observation
// rows span [row_lo, row_hi).
struct Block {
  int f0, f1, row_lo, row_hi;
};

__device__ __forceinline__ Block row_block(int rb, int G, int n_obs) {
  Block blk;
  blk.f0 = rb * MAXF;
  blk.f1 = min((n_obs + 15) / 16 * G, blk.f0 + MAXF);
  blk.row_lo = blk.f0 / G * 16;
  blk.row_hi = min(n_obs, ((blk.f1 - 1) / G + 1) * 16);
  return blk;
}

// The block's packed query rows into sQ (zeros where padding).
template <int HD>
__device__ __forceinline__ void stage_q(bf16* sQ, const bf16* q,
                                        const Block& blk, int b, int n_obs,
                                        int H, int G, int kvh) {
  using S = Shape<HD>;
  for (int i = threadIdx.x; i < ROWS * S::CH; i += THREADS) {
    const int p = i / S::CH, c = i % S::CH;
    const int f = blk.f0 + p / 16, row = f / G * 16 + p % 16;
    const bool ok = f < blk.f1 && row < n_obs;
    const bf16* src =
        ok ? q + (((size_t)b * n_obs + row) * H + kvh * G + f % G) * HD + c * 8
           : q;
    cp_async16(sQ + p * S::LD + c * 8, src, ok);
  }
}

// Keys [k0, k0 + BK) of kv head kvh into sK (zeros at or past Sk).
template <int HD>
__device__ __forceinline__ void stage_k(bf16* sK, const bf16* k, int b,
                                        int k0, int Sk, int KV, int kvh) {
  using S = Shape<HD>;
  for (int i = threadIdx.x; i < BK * S::CH; i += THREADS) {
    const int r = i / S::CH, c = i % S::CH;
    const bool ok = k0 + r < Sk;
    const bf16* src =
        ok ? k + (((size_t)b * Sk + k0 + r) * KV + kvh) * HD + c * 8 : k;
    cp_async16(sK + r * S::LD + c * 8, src, ok);
  }
}

// This warp's FPW A fragments (every k-step) from sQ.
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[FPW][HD / 16][4],
                                       const bf16* sQ) {
  using S = Shape<HD>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const bf16* row = sQ + ((warp * FPW + f) * 16 + (lane & 7) +
                            ((lane >> 3) & 1) * 8) * S::LD + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks) ldsm_x4(qa[f][ks], row + ks * 16);
  }
}

// S = Q K^T of this warp's fragments over the BK keys of sK: s[f][n][e] is
// (packed row 16 (warp FPW + f) + lane / 4 + 8 (e / 2), key 8 n + 2 (lane
// % 4) + e % 2).  Both launches call this, so each logit is the same MMAs
// (k-steps in order, from zero) in each.
template <int HD>
__device__ __forceinline__ void logits(const uint32_t (&qa)[FPW][HD / 16][4],
                                       const bf16* sK,
                                       float (&s)[FPW][NF][4]) {
  using S = Shape<HD>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int f = 0; f < FPW; ++f)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[f][n][e] = 0.f;
  const bf16* row = sK + ((lane & 7) + (lane >> 4) * 8) * S::LD +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < S::KS; ++ks) {
#pragma unroll
    for (int np = 0; np < NF / 2; ++np) {  // keys 16 np .. 16 np + 15
      uint32_t bk[4];
      ldsm_x4(bk, row + np * 16 * S::LD + ks * 16);
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        mma_bf16(s[f][2 * np], qa[f][ks], bk[0], bk[1]);
        mma_bf16(s[f][2 * np + 1], qa[f][ks], bk[2], bk[3]);
      }
    }
  }
}

// Bit 2 n + e: key k0 + 8 n + 2 (lane % 4) + e exists and passes kv_mask
// (which covers keys < n_prompt only).
__device__ __forceinline__ unsigned key_bits(int k0, int Sk, int n_prompt,
                                             const uint8_t* kvm) {
  const int t = threadIdx.x & 3;
  unsigned bits = 0;
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kpos = k0 + 8 * n + 2 * t + e;
      const bool ok = kpos < Sk && (kvm == nullptr || kpos >= n_prompt ||
                                    kvm[kpos] != 0);
      bits |= (unsigned)ok << (2 * n + e);
    }
  return bits;
}

// Row qpos sees key kpos (causal, window).
__device__ __forceinline__ bool sees(int kpos, int qpos, int window) {
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

// Every row of [row_lo, row_hi) sees every key of [k0, k0 + BK): the tile
// needs no mask (the common case: all but the causal diagonal's tiles).
__device__ __forceinline__ bool open_tile(int k0, int row_lo, int row_hi,
                                          int q_offset, int window, int Sk,
                                          int n_prompt, bool kv_masked) {
  return k0 + BK - 1 <= q_offset + row_lo && k0 + BK <= Sk &&
         (window <= 0 || q_offset + row_hi - 1 - k0 < window) &&
         (!kv_masked || k0 >= n_prompt);
}

// One tile's logits into this thread's rows' online (m, l), in base 2.
// MASKED: a key a row does not see (or a padded row) scores nothing;
// otherwise every (row, key) counts, padded rows too (they are never
// stored).
template <bool MASKED>
__device__ __forceinline__ void row_update(float (&s)[FPW][NF][4],
                                           float (&m)[FPW][2],
                                           float (&l)[FPW][2],
                                           const bool (&real)[FPW][2],
                                           const int (&qpos)[FPW][2], int k0,
                                           unsigned kb, int window,
                                           float qscale) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      unsigned ok = ~0u;
      float tmax = NEG_INF;
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = __fmul_rn(s[f][n][2 * e2 + e], qscale);
          if (MASKED) {
            const bool v = real[f][e2] && ((kb >> (2 * n + e)) & 1u) &&
                           sees(k0 + 8 * n + 2 * tig + e, qpos[f][e2],
                                window);
            x = v ? x : NEG_INF;
            ok = v ? ok : ok & ~(1u << (2 * n + e));
          }
          s[f][n][2 * e2 + e] = x;
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 2));
      const float m_new = fmaxf(m[f][e2], tmax);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(__fsub_rn(s[f][n][2 * e2 + e], m_new));
          psum += ((ok >> (2 * n + e)) & 1u) ? p : 0.f;
        }
      psum += __shfl_xor_sync(FULL, psum, 1);
      psum += __shfl_xor_sync(FULL, psum, 2);
      l[f][e2] = l[f][e2] * ex2(__fsub_rn(m[f][e2], m_new)) + psum;
      m[f][e2] = m_new;
    }
  }
}

// Each key column's weight exp2(s - m) / l summed over this thread's two
// rows of one fragment (1 / l = 0: an invalid or padded row adds exactly
// zero).  MASKED: a key a row does not see adds nothing; otherwise every
// row sees every key (an open tile).
template <bool MASKED>
__device__ __forceinline__ void column_weights(const float (&s)[NF][4],
                                               float (&col)[NF][2],
                                               const float (&mr)[2],
                                               const float (&inv)[2],
                                               const int (&qpos)[2], int k0,
                                               unsigned kb, int window,
                                               float qscale) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float w = __fmul_rn(
            ex2(__fsub_rn(__fmul_rn(s[n][2 * e2 + e], qscale), mr[e2])),
            inv[e2]);
        if (MASKED) {
          const bool v = inv[e2] != 0.f && ((kb >> (2 * n + e)) & 1u) &&
                         sees(k0 + 8 * n + 2 * tig + e, qpos[e2], window);
          w = v ? w : 0.f;
        }
        col[n][e] = e2 == 0 ? w : col[n][e] + w;
      }
  }
}

// Launch (a).  Grid (n_split x row blocks, KV, B), THREADS threads.
template <int HD>
__global__ void __launch_bounds__(THREADS)
obs_row_stats_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const uint8_t* __restrict__ kv_mask,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int n_obs, int H, int Sk, int KV, int n_prompt,
                  int q_offset, int window, int n_split, float qscale) {
  using S = Shape<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // ROWS x LD
  bf16* sK = sQ + ROWS * S::LD;               // NST x BK x LD
  const int G = H / KV, split = blockIdx.x % n_split;
  const Block blk = row_block(blockIdx.x / n_split, G, n_obs);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const uint8_t* kvm = kv_mask ? kv_mask + (size_t)b * n_prompt : nullptr;
  launch_dependents();  // launch (b) may start and stage its K and Q

  // this split's share of the key tiles the block's rows see
  const int k_end = min(Sk, q_offset + blk.row_hi);
  int k_begin =
      window > 0 ? max(0, q_offset + blk.row_lo - window + 1) / BK * BK : 0;
  const int per = ((max(k_end - k_begin, 0) + BK - 1) / BK + n_split - 1) /
                  n_split;
  k_begin += split * per * BK;
  const int n_t = min(per, max(0, (k_end - k_begin + BK - 1) / BK));

  // this thread's rows: fragment f, half e2
  int qpos[FPW][2], row[FPW][2], head[FPW];
  bool real[FPW][2];
  float m[FPW][2], l[FPW][2];
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int fi = blk.f0 + warp * FPW + f;
    head[f] = kvh * G + fi % G;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      row[f][e2] = fi / G * 16 + gid + 8 * e2;
      real[f][e2] = fi < blk.f1 && row[f][e2] < n_obs;
      qpos[f][e2] = q_offset + row[f][e2];
      m[f][e2] = NEG_INF;
      l[f][e2] = 0.f;
    }
  }

  if (n_t > 0) {
    stage_q<HD>(sQ, q, blk, b, n_obs, H, G, kvh);
#pragma unroll
    for (int t = 0; t < NST - 1; ++t) {  // the Q rows ride with tile 0
      if (t < n_t)
        stage_k<HD>(sK + t * BK * S::LD, k, b, k_begin + t * BK, Sk, KV, kvh);
      cp_async_commit();
    }
    uint32_t qa[FPW][S::KS][4];
    for (int t = 0; t < n_t; ++t) {
      cp_async_wait<NST - 2>();  // tile t (and the Q rows) landed
      __syncthreads();           // ... for every thread; tile t - 1 is read
      if (t == 0) load_q<HD>(qa, sQ);
      const int tn = t + NST - 1;  // refill the stage tile t - 1 held
      if (tn < n_t)
        stage_k<HD>(sK + (tn % NST) * BK * S::LD, k, b, k_begin + tn * BK,
                    Sk, KV, kvh);
      cp_async_commit();
      const int k0 = k_begin + t * BK;
      float s[FPW][NF][4];
      logits<HD>(qa, sK + (t % NST) * BK * S::LD, s);
      if (open_tile(k0, blk.row_lo, blk.row_hi, q_offset, window, Sk,
                    n_prompt, kvm != nullptr))
        row_update<false>(s, m, l, real, qpos, k0, 0u, window, qscale);
      else
        row_update<true>(s, m, l, real, qpos, k0,
                         key_bits(k0, Sk, n_prompt, kvm), window, qscale);
    }
    cp_async_wait<0>();
  }
  if (tig == 0) {
#pragma unroll
    for (int f = 0; f < FPW; ++f)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        if (real[f][e2]) {
          const size_t o =
              ((size_t)(b * H + head[f]) * n_split + split) * n_obs +
              row[f][e2];
          m_out[o] = m[f][e2];
          l_out[o] = l[f][e2];
        }
  }
}

// Launch (b).  Grid (key ranges of t_per tiles, KV, B), THREADS threads;
// qstages 1 (one row block) or 2 (the next row block's Q rows and
// partials load while this one is scored).  A CTA walks (row block, key
// tile) steps, row blocks outer, through a 2-stage ring of K tiles.
// Dynamic shared memory: the K ring, qstages x (packed Q rows, raw
// partials), each row's final (m, 1 / l), the fragments' column sums, the
// heads' column sums over the range.
template <int HD>
__global__ void __launch_bounds__(THREADS)
obs_column_means_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const uint8_t* __restrict__ kv_mask,
                     const uint8_t* __restrict__ row_valid,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in, float* __restrict__ out,
                     int n_obs, int H, int Sk, int KV, int n_prompt,
                     int q_offset, int window, int n_split, int t_per,
                     int qstages, float qscale) {
  using S = Shape<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // 2 x BK x LD
  bf16* sQ = sK + 2 * BK * S::LD;             // qstages x ROWS x LD
  // raw partials: qstages x n_split x (m row, l row) x ROWS
  float* sP = reinterpret_cast<float*>(sQ + qstages * ROWS * S::LD);
  float* s_m = sP + qstages * n_split * 2 * ROWS;  // ROWS
  float* s_inv = s_m + ROWS;                       // ROWS
  float* s_red = s_inv + ROWS;                     // MAXF x BK
  float* s_col = s_red + MAXF * BK;                // G x t_per x BK
  const int G = H / KV, kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, gid = lane >> 2, tig = lane & 3;
  const int k_lo = blockIdx.x * t_per * BK;
  const int n_cols = min(t_per * BK, n_prompt - k_lo);  // this CTA's keys
  // the tiles some row may see (none past q_offset + n_obs - 1) ...
  const int nt = max(0, min((n_cols + BK - 1) / BK,
                            (q_offset + n_obs - k_lo + BK - 1) / BK));
  const int k_hi = k_lo + nt * BK;
  // ... and the row blocks with a row that may see one of them (a run)
  const int n_rb = ((n_obs + 15) / 16 * G + MAXF - 1) / MAXF;
  int rb_lo = n_rb, rb_hi = 0;
  for (int rb = 0; rb < n_rb && nt > 0; ++rb) {
    const Block blk = row_block(rb, G, n_obs);
    if (q_offset + blk.row_hi - 1 >= k_lo &&
        (window <= 0 || q_offset + blk.row_lo - (k_hi - 1) < window)) {
      rb_lo = min(rb_lo, rb);
      rb_hi = rb + 1;
    }
  }
  for (int i = tid; i < G * t_per * BK; i += THREADS) s_col[i] = 0.f;

  // row block rb's packed Q rows and this thread's row's raw partials
  // (the partials once launch (a) is done: this launch may start early)
  auto stage_rows = [&](int rb, int slot) {
    const Block blk = row_block(rb, G, n_obs);
    stage_q<HD>(sQ + slot * ROWS * S::LD, q, blk, b, n_obs, H, G, kvh);
    const int f = blk.f0 + tid / 16, row = f / G * 16 + tid % 16;
    wait_for_predecessor();  // launch (a)'s partials are stored
    if (tid < ROWS && f < blk.f1 && row < n_obs) {
      const float* mo =
          m_in + ((size_t)(b * H + kvh * G + f % G) * n_split) * n_obs + row;
      const float* lo = l_in + (mo - m_in);
      float* P = sP + slot * n_split * 2 * ROWS + tid;
      for (int sp = 0; sp < n_split; ++sp) {
        cp_async4(P + 2 * sp * ROWS, mo + (size_t)sp * n_obs);
        cp_async4(P + (2 * sp + 1) * ROWS, lo + (size_t)sp * n_obs);
      }
    }
  };
  // step j: row block rb_lo + j / nt against tile j % nt, in K slot j % 2
  // (one tile: slot 0, staged once for every row block)
  const int steps = (rb_hi - rb_lo) * nt;
  auto kslot = [&](int j) { return nt == 1 ? 0 : j & 1; };
  auto stage_step = [&](int j) {
    if (j < steps) {
      const int t = j % nt, rb = rb_lo + j / nt;
      if (nt > 1 || j == 0)
        stage_k<HD>(sK + kslot(j) * BK * S::LD, k, b, k_lo + t * BK, Sk, KV,
                    kvh);
      if (t == 0) stage_rows(rb, qstages == 2 ? (rb - rb_lo) & 1 : 0);
    }
    cp_async_commit();
  };

  const uint8_t* kvm = kv_mask ? kv_mask + (size_t)b * n_prompt : nullptr;
  stage_step(0);
  for (int j = 0; j < steps; ++j) {
    const int t = j % nt, rb = rb_lo + j / nt, k0 = k_lo + t * BK;
    const int slot = qstages == 2 ? (rb - rb_lo) & 1 : 0;
    const Block blk = row_block(rb, G, n_obs);
    // the next step's K tile (and row block) while this one is scored:
    // its slots were last read by step j - 1 (or row block rb - 1; with
    // one Q slot there is one row block)
    stage_step(j + 1);
    cp_async_wait<1>();
    if (t == 0) {
      // this thread's packed row: its final (m, 1 / l) from the partials
      // in split order; a padded or invalid row gets (+1e30, 0), so its
      // weights exp2(s - m) / l are exactly zero
      const int fp = blk.f0 + tid / 16, rp = fp / G * 16 + tid % 16;
      const bool live =
          tid < ROWS && fp < blk.f1 && rp < n_obs &&
          (row_valid == nullptr || row_valid[(size_t)b * n_obs + rp] != 0);
      __syncthreads();  // the row block landed for every thread
      const float* P = sP + slot * n_split * 2 * ROWS + tid;
      float mr = NEG_INF, lr = 0.f;
      if (live) {
        for (int sp = 0; sp < n_split; ++sp) mr = fmaxf(mr, P[2 * sp * ROWS]);
        for (int sp = 0; sp < n_split; ++sp)
          lr = __fmaf_rn(P[(2 * sp + 1) * ROWS],
                         ex2(__fsub_rn(P[2 * sp * ROWS], mr)), lr);
      }
      if (tid < ROWS) {
        s_m[tid] = live ? mr : -NEG_INF;
        s_inv[tid] = live ? 1.f / fmaxf(lr, L_FLOOR) : 0.f;
      }
    }
    __syncthreads();  // tile j and the rows' (m, 1 / l) ready
    uint32_t qa[FPW][S::KS][4];
    load_q<HD>(qa, sQ + slot * ROWS * S::LD);
    float s[FPW][NF][4];
    logits<HD>(qa, sK + kslot(j) * BK * S::LD, s);
    const bool open = open_tile(k0, blk.row_lo, blk.row_hi, q_offset,
                                window, Sk, n_prompt, kvm != nullptr);
    const unsigned kb = open ? 0u : key_bits(k0, Sk, n_prompt, kvm);
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int fi = blk.f0 + warp * FPW + f;
      float mr[2], inv[2];
      int qpos[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int pr = (warp * FPW + f) * 16 + gid + 8 * e2;
        mr[e2] = s_m[pr];
        inv[e2] = s_inv[pr];
        qpos[e2] = q_offset + fi / G * 16 + gid + 8 * e2;
      }
      float col[NF][2];
      if (open)
        column_weights<false>(s[f], col, mr, inv, qpos, k0, 0u, window,
                              qscale);
      else
        column_weights<true>(s[f], col, mr, inv, qpos, k0, kb, window,
                             qscale);
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            col[n][e] += __shfl_xor_sync(FULL, col[n][e], o);
      if (gid == 0) {
#pragma unroll
        for (int n = 0; n < NF; ++n)
          *reinterpret_cast<float2*>(
              s_red + (warp * FPW + f) * BK + 8 * n + 2 * tig) =
              make_float2(col[n][0], col[n][1]);
      }
    }
    __syncthreads();  // the fragments' sums are in; tile j is read
    if (tid < BK) {  // each head's column sums, fragments in order
      for (int x = 0; x < MAXF && blk.f0 + x < blk.f1; ++x)
        s_col[((blk.f0 + x) % G * t_per + t) * BK + tid] +=
            s_red[x * BK + tid];
    }
  }
  __syncthreads();
  // every key of the range: the sums (exact zeros where no row sees it)
  for (int i = tid; i < G * n_cols; i += THREADS) {
    const int g = i / n_cols, c = i % n_cols;
    out[((size_t)b * H + kvh * G + g) * n_prompt + k_lo + c] =
        s_col[g * t_per * BK + c] / (float)n_obs;
  }
}

}  // namespace tc

template <int HD>
cudaError_t launch_fma(const float* q, const float* k,
                       const uint8_t* kv_mask, const uint8_t* row_valid,
                       float* m_buf, float* l_buf, float* out, int B,
                       int n_obs, int H, int Sk, int KV, int n_prompt,
                       int q_offset, int window, int n_split,
                       cudaStream_t st) {
  using namespace fp32;
  const float scale = 1.f / sqrtf((float)HD);
  const int smem1 = (RQ + BK) * (HD + 1) * sizeof(float);
  const int smem2 = smem1 + RQ * (BK + 1) * sizeof(float);
  auto* k1 = obs_row_stats<float, HD>;
  auto* k2 = obs_column_means<float, HD>;
  cudaError_t err = allow_smem(k1, smem1);
  if (err == cudaSuccess) err = allow_smem(k2, smem2);
  if (err != cudaSuccess) return err;
  dim3 g1(n_split * ((n_obs + RQ - 1) / RQ), H, B);
  k1<<<g1, THREADS, smem1, st>>>(q, k, kv_mask, m_buf, l_buf, n_obs, H, Sk,
                                 KV, n_prompt, q_offset, window, n_split,
                                 scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2((n_prompt + BK - 1) / BK, H, B);
  k2<<<g2, THREADS, smem2, st>>>(q, k, kv_mask, row_valid, m_buf, l_buf, out,
                                 n_obs, H, Sk, KV, n_prompt, q_offset, window,
                                 n_split, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const uint8_t* kv_mask, const uint8_t* row_valid,
                       float* m_buf, float* l_buf, float* out, int B,
                       int n_obs, int H, int Sk, int KV, int n_prompt,
                       int q_offset, int window, int n_split, int t_per,
                       cudaStream_t st) {
  using namespace tc;
  using S = Shape<HD>;
  if (t_per < 1) return cudaErrorInvalidValue;
  const int G = H / KV;
  const int n_rb = ((n_obs + 15) / 16 * G + MAXF - 1) / MAXF;
  const int qstages = n_rb > 1 ? 2 : 1;
  const float qscale = 1.f / sqrtf((float)HD) * LOG2E;
  constexpr int smem1 = (ROWS + NST * BK) * S::LD * 2;
  const int smem2 = (2 * BK + qstages * ROWS) * S::LD * 2 +
                    (qstages * n_split * 2 * ROWS + 2 * ROWS + MAXF * BK +
                     G * t_per * BK) * 4;
  auto* k1 = obs_row_stats_mma<HD>;
  auto* k2 = obs_column_means_mma<HD>;
  static const cudaError_t allowed1 = allow_smem(k1, smem1);
  if (allowed1 != cudaSuccess) return allowed1;
  if (smem2 > MAX_SMEM) return cudaErrorInvalidValue;
  static int allowed2 = 0;  // the largest ceiling set so far
  if (smem2 > allowed2) {
    const cudaError_t err = allow_smem(k2, smem2);
    if (err != cudaSuccess) return err;
    allowed2 = smem2;
  }
  k1<<<dim3(n_split * n_rb, KV, B), THREADS, smem1, st>>>(
      q, k, kv_mask, m_buf, l_buf, n_obs, H, Sk, KV, n_prompt, q_offset,
      window, n_split, qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // launch (b) may start while (a) runs (programmatic dependent launch):
  // its K tiles and Q rows load beside (a)'s tail
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n_prompt + BK - 1) / BK + t_per - 1) / t_per, KV, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k2, q, k, kv_mask, row_valid,
                           (const float*)m_buf, (const float*)l_buf, out,
                           n_obs, H, Sk, KV, n_prompt, q_offset, window,
                           n_split, t_per, qstages, qscale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// float32 on the FMA kernels, bf16 on the tensor-core kernels.
template <int HD>
cudaError_t dispatch(int dtype, const void* q, const void* k,
                     const uint8_t* kv_mask, const uint8_t* row_valid,
                     float* m_buf, float* l_buf, float* out, int B, int n_obs,
                     int H, int Sk, int KV, int n_prompt, int q_offset,
                     int window, int n_split, int t_per, cudaStream_t st) {
  if (dtype == DTYPE_F32)
    return launch_fma<HD>((const float*)q, (const float*)k, kv_mask,
                          row_valid, m_buf, l_buf, out, B, n_obs, H, Sk, KV,
                          n_prompt, q_offset, window, n_split, st);
  if (dtype == DTYPE_BF16)
    return launch_mma<HD>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                          kv_mask, row_valid, m_buf, l_buf, out, B, n_obs, H,
                          Sk, KV, n_prompt, q_offset, window, n_split, t_per,
                          st);
  return cudaErrorInvalidValue;
}

}  // namespace

// kv_mask / row_valid may be null (all keys / rows valid); window <= 0
// means no window.  m_buf / l_buf are (B, H, n_split, n_obs) float32
// scratch; n_split >= 1 key splits share launch (a); in bf16 each CTA of
// launch (b) takes t_per >= 1 key tiles (float32: one), and its shared
// memory, which grows with n_split, t_per and H / KV, must fit a CTA.
extern "C" int lookahead_score(const void* q, const void* k,
                               const void* kv_mask, const void* row_valid,
                               void* m_buf, void* l_buf, void* out, int B,
                               int n_obs, int H, int Sk, int KV, int hd,
                               int n_prompt, int q_offset, int window,
                               int n_split, int t_per, int dtype,
                               void* stream) {
  if (KV < 1 || H % KV || n_obs < 1 || n_split < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* km = (const uint8_t*)kv_mask;
  const uint8_t* rv = (const uint8_t*)row_valid;
  float *mb = (float*)m_buf, *lb = (float*)l_buf, *o = (float*)out;
  switch (hd) {
    case 32: return dispatch<32>(dtype, q, k, km, rv, mb, lb, o, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, t_per, st);
    case 64: return dispatch<64>(dtype, q, k, km, rv, mb, lb, o, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, t_per, st);
    case 128: return dispatch<128>(dtype, q, k, km, rv, mb, lb, o, B, n_obs, H, Sk, KV, n_prompt, q_offset, window, n_split, t_per, st);
    default: return cudaErrorInvalidValue;
  }
}
