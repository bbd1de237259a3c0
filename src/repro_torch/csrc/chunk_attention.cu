// Chunk attention: C query rows of one prefill chunk (or the 32 lookahead
// observation rows) at absolute position q_offset attend over a K-deep
// key/value buffer whose column j holds position j.  Earlier columns are
// visible, the chunk is causal within itself, later columns are invisible,
// and an optional sliding window hides keys with q_pos - k_pos >= window.
//
// Replaces: src/repro/kernels/chunk_attention.py, chunk_attention_pallas
// (pallas_call at :138), through the entry chunk_attention; and
// src/repro/kernels/flash_attention.py, flash_attention_pallas
// (pallas_call at :99), through the entry flash_attention: monolithic
// self-attention of a whole sequence (Sq == Sk), which is the causal chunk
// with q_offset = 0 and C = K, or with CAUSAL false every key visible
// (the window still applies).
//
// Also replaces src/repro/kernels/chunk_attention.py,
// chunk_attention_masses_pallas (pallas_call at :289), through the entry
// chunk_attention_masses: the chunk's attention output, bitwise the entry
// chunk_attention's, plus masses[b, h, j] = sum over the rows i with
// q_offset + i < n_total of row i's softmax mass on key j (B, H, K)
// float32, the h2o eviction score of one prefill chunk.  The Pallas kernel
// runs its key axis twice in one sequential grid (the attention recurrence,
// then a second sweep over the keys once (m, l) are final); a chunk's rows
// span several CTAs here, so a column sum is a reduction across CTAs, and
// the entry makes two launches with no atomics (the masses are
// deterministic):
//   (a) the attention kernel with STATS set (tag chunk_masses_tag): the
//       same body, which only adds a store of each row's final (m, l) to a
//       (B, H, C) float32 scratch, so out stays bitwise kernel 1's;
//   (b) a column-masses kernel: one CTA per (key tile, head, batch)
//       recomputes the tile's logits for the chunk's rows that can see it,
//       exactly as (a) forms them (the same operands in the same tile
//       positions, the same tensor-core instructions or FMA order, the
//       same scale), takes exp(s - m) / l, zeroes rows at or past n_total
//       and sums over rows.  A tile no counted row can see (past the
//       chunk's last visible key, or before the window of every row)
//       writes zeros without reading K.
// (b) is bound like (a)'s Q.K^T half: operations, 2*hd*H*sum_i(visible
// keys of row i) over the bf16 peak; it adds the masses' writes (B*H*K*4
// bytes) to (a)'s bytes.
//
// Layout: q (B, C, H, hd), k/v (B, K, KV, hd) contiguous, fp32 or bf16;
// out (B, C, H, hd) in q's type.  GQA: query head h reads kv head
// h / (H / KV).
//
// Key mask (the entry flash_attention only): kv_mask (B, K) bytes, 0 for a
// key that no row may see (the bucket-padded rows of a padded prefill;
// the JAX package sends such a call to its jnp attention, not to Pallas,
// so this form replaces no Pallas kernel).  A null kv_mask runs the
// unmasked kernels unchanged: the Hopper tile's MASKED instantiations are
// separate, and this file's kernels test the pointer.  Contract: each row
// sees at least one valid key (a row that sees none gets zeros; the plain
// version's softmax over -1e30 logits would give the mean of V).
//
// Each entry instantiates the kernels with a tag type of its own name
// (attention_sm90<chunk_attention_tag, ...> against
// attention_sm90<flash_attention_tag, ...>, and the merge of a split key
// range, combine_splits<chunk_attention_tag, ...>), so a profile reads
// them apart.
//
// * bf16 at head dims 64 and 128 (the serving path of every entry): the
//   Hopper tile of attention_sm90.cuh, wgmma for both products and a TMA +
//   mbarrier ring on 128-row query tiles and 128-key K/V tiles; kernel 2's
//   (b) is its column_masses_sm90.  Those shapes reach nothing else.
// * bf16 at head dim 32: this file's mma.sync tiles (attention_mma,
//   column_masses_mma): 4 warps of 16 query rows, 64-key tiles through a
//   double-buffered cp.async ring, FlashAttention-2 style: a warp keeps its
//   Q rows as A fragments, masks and rescales S in registers, and reuses
//   the S fragment layout as P's A operand after rounding P to bf16 (m, l
//   and the rescale stay f32); V's B fragments come from ldmatrix.trans.
// * fp32 (the float32 configs): this file's CUDA-core kernels
//   (attention_fma, column_masses_fma), 256 threads, 4 lanes per query row.
// The tiles of this file put one CTA on each (64-row query tile, head,
// batch).  The TPU grid's sequential key axis becomes a loop inside the
// CTA over key tiles, with the online-softmax (m, l, acc) recurrence in
// registers; the loop stops at the tile's last visible key, q_offset +
// row_end - 1 (the causal block pruning of chunk_attention.py:62), and
// with a window starts at the first key any row of the tile sees.  Query
// tiles are numbered from the last one down, so the tiles with the longest
// key loops of a causal sequence start first and the short ones fill in.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): the larger of
// 4*hd*H*sum_i(visible keys of row i) operations / 989e12 and the bytes of
// q, the visible k/v rows and out / 3.35e12.  A 256-row chunk deep in a
// 4k prompt is operation-bound (~17 us at the data-sheet peaks of an H100
// SXM at its full 700 W).  What the Hopper tile leaves is listed in
// attention_sm90.cuh's header.
#include "attention_sm90.cuh"
#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per shared-memory tile
constexpr int THREADS = 256; // fp32 path: 4 lanes per query row
constexpr int NJ = BK / 4;   // fp32 path: logits per lane per tile
constexpr int MTHREADS = 128;  // bf16 path: 4 warps x 16 query rows

// Query tile of this CTA: the last tile first (see the header).
__device__ __forceinline__ int tile_row0() {
  return (gridDim.x - 1 - blockIdx.x) * BQ;
}

// the entry a kernel instantiation belongs to: it names the kernel
struct chunk_attention_tag {};
struct flash_attention_tag {};
struct chunk_masses_tag {};

// Store one row's final online-softmax statistics for the column-masses
// pass: (m, l) of row `row` of head h of batch b in a (B, H, C) scratch.
__device__ __forceinline__ void store_stats(float* m_out, float* l_out,
                                            int b, int h, int H, int C,
                                            int row, float m, float l) {
  const size_t o = ((size_t)b * H + h) * C + row;
  m_out[o] = m;
  l_out[o] = l;
}

template <typename Entry, typename T, int HD, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(THREADS)
attention_fma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ m_out, float* __restrict__ l_out,
              const uint8_t* __restrict__ kv_mask, int C, int H, int K,
              int KV, int q_offset, int window, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                  // BQ x (HD + 1)
  float* sK = sQ + BQ * (HD + 1);    // BK x (HD + 1)
  float* sV = sK + BK * (HD + 1);    // BK x HD

  const int q0 = tile_row0();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 2;  // query row of this lane within the tile
  const int c4 = tid & 3;  // lane within the row's group of 4

  const size_t q_row = (size_t)H * HD;
  const size_t k_row = (size_t)KV * HD;
  const T* qb = q + (size_t)b * C * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * K * k_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * K * k_row + (size_t)kvh * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int rr = i / HD, d = i % HD;
    sQ[rr * (HD + 1) + d] =
        (q0 + rr < C) ? to_f32(qb[(size_t)(q0 + rr) * q_row + d]) : 0.f;
  }

  const int rows = min(BQ, C - q0);
  // past the last visible key
  const int k_end = CAUSAL ? min(K, q_offset + q0 + rows) : K;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_offset + q0 - window + 1) / BK) * BK;
  const bool row_ok = q0 + r < C;
  const int qpos = q_offset + q0 + r;

  float m = NEG_INF, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < K) {
        kx = to_f32(kb[(size_t)(k0 + c) * k_row + d]);
        vx = to_f32(vb[(size_t)(k0 + c) * k_row + d]);
      }
      sK[c * (HD + 1) + d] = kx;
      sV[c * HD + d] = vx;
    }
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = sQ[r * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] += qd * sK[(c4 + 4 * j) * (HD + 1) + d];
    }
    unsigned okbits = 0;
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kpos = k0 + c4 + 4 * j;
      const bool ok = row_ok && kpos < K && (!CAUSAL || kpos <= qpos) &&
                      (window <= 0 || qpos - kpos < window) &&
                      (kv_mask == nullptr || kv_mask[(size_t)b * K + kpos]);
      s[j] = ok ? s[j] * scale : NEG_INF;
      okbits |= (unsigned)ok << j;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j] = ((okbits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) acc[i] *= corr;
    // key c's probability lives in lane (row base + c % 4), slot c / 4
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float p = __shfl_sync(0xffffffffu, s[j], (lane & ~3) | cc);
        const int c = 4 * j + cc;
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) acc[i] += p * sV[c * HD + c4 + 4 * i];
      }
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, L_FLOOR);
    T* ob = out + ((size_t)b * C + q0 + r) * q_row + (size_t)h * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) ob[c4 + 4 * i] = from_f32<T>(acc[i] * inv);
    if constexpr (STATS) {
      if (c4 == 0) store_stats(m_out, l_out, b, h, H, C, q0 + r, m, l);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 regs: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 8+2t..),
//                 (row g+8, k 8+2t..)
//   B 16x8  regs: (k 2t..2t+1, col g), (k 8+2t.., col g)
//   C 16x8  f32:  (row g, col 2t), (row g, col 2t+1), (row g+8, col 2t),
//                 (row g+8, col 2t+1)
template <typename Entry, int HD, bool CAUSAL, bool STATS>
__global__ void __launch_bounds__(MTHREADS)
attention_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
              float* __restrict__ l_out, const uint8_t* __restrict__ kv_mask,
              int C, int H, int K, int KV, int q_offset, int window,
              float scale) {
  constexpr int LD = HD + 8;  // row stride (halves): conflict-free fragments
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  constexpr int NT = BK / 8;  // n8 tiles of S per warp
  constexpr int TILE = BK * LD;  // halves of one K or V stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LD
  __nv_bfloat16* sK = sQ + BQ * LD;  // 2 stages x BK x LD
  __nv_bfloat16* sV = sK + 2 * TILE;  // 2 stages x BK x LD

  const int q0 = tile_row0();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_row = (size_t)H * HD;
  const size_t k_row = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + (size_t)b * C * q_row + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * K * k_row + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * K * k_row + (size_t)kvh * HD;

  for (int i = tid; i < BQ * CH; i += MTHREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < C;
    cp_async16(sQ + r * LD + 8 * c,
               qb + (size_t)(ok ? q0 + r : 0) * q_row + 8 * c, ok);
  }
  cp_async_commit();

  // stage one 64-key tile of K and V into `stage` (zeros past K)
  auto load_tile = [&](int k0, int stage) {
    __nv_bfloat16* dk = sK + stage * TILE;
    __nv_bfloat16* dv = sV + stage * TILE;
#pragma unroll
    for (int it = 0; it < BK * CH / MTHREADS; ++it) {
      const int i = tid + it * MTHREADS;
      const int c = i / CH, ch = i % CH;
      const bool ok = k0 + c < K;
      const size_t src = (size_t)(ok ? k0 + c : 0) * k_row + 8 * ch;
      cp_async16(dk + c * LD + 8 * ch, kb + src, ok);
      cp_async16(dv + c * LD + 8 * ch, vb + src, ok);
    }
    cp_async_commit();
  };

  const int rows = min(BQ, C - q0);
  const int k_end = CAUSAL ? min(K, q_offset + q0 + rows) : K;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_offset + q0 - window + 1) / BK) * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  if (n_tiles > 0) {
    load_tile(k_begin, 0);  // in flight while Q is read
    cp_async_wait<1>();  // the Q group has landed (the tile may not have)
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  const int wr = warp * 16;  // this warp's first row in the tile
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p = sQ + (wr + g) * LD + 16 * kk + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * LD);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * LD + 8);
  }

  // the two query rows this lane holds in every C fragment
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const int qp_lo = q_offset + r_lo, qp_hi = q_offset + r_hi;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const int stage = it & 1;
    // double buffering: the next tile streams in while this one computes
    if (it + 1 < n_tiles) {
      load_tile(k0 + BK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed for every thread
    const __nv_bfloat16* tK = sK + stage * TILE;
    const __nv_bfloat16* tV = sV + stage * TILE;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* p = tK + (8 * j + g) * LD + 16 * kk + 2 * t;
        mma_bf16(s[j], qa[kk], ld32(p), ld32(p + 8));
      }
    }
    unsigned ok_lo = 0, ok_hi = 0;  // bit 2j+i: key 8j+2t+i visible
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kp = k0 + 8 * j + 2 * t + i;
        const bool key_ok =
            kp < K && (kv_mask == nullptr || kv_mask[(size_t)b * K + kp]);
        const bool a = r_lo < C && key_ok && (!CAUSAL || kp <= qp_lo) &&
                       (window <= 0 || qp_lo - kp < window);
        const bool c = r_hi < C && key_ok && (!CAUSAL || kp <= qp_hi) &&
                       (window <= 0 || qp_hi - kp < window);
        s[j][i] = a ? s[j][i] * scale : NEG_INF;
        s[j][2 + i] = c ? s[j][2 + i] * scale : NEG_INF;
        ok_lo |= (unsigned)a << (2 * j + i);
        ok_hi |= (unsigned)c << (2 * j + i);
        mx_lo = fmaxf(mx_lo, s[j][i]);
        mx_hi = fmaxf(mx_hi, s[j][2 + i]);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[j][i] = ((ok_lo >> (2 * j + i)) & 1u) ? expf(s[j][i] - mn_lo) : 0.f;
        s[j][2 + i] =
            ((ok_hi >> (2 * j + i)) & 1u) ? expf(s[j][2 + i] - mn_hi) : 0.f;
        ps_lo += s[j][i];
        ps_hi += s[j][2 + i];
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      ps_lo += __shfl_xor_sync(0xffffffffu, ps_lo, o2);
      ps_hi += __shfl_xor_sync(0xffffffffu, ps_hi, o2);
    }
    const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * c_lo + ps_lo;
    l_hi = l_hi * c_hi + ps_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= c_lo;
      o[dt][1] *= c_lo;
      o[dt][2] *= c_hi;
      o[dt][3] *= c_hi;
    }
    // O += P V: S tiles 2kk and 2kk+1 are exactly P's A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = tV + (16 * kk + (lane & 15)) * LD;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + 8 * dt);
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with `stage` before its refill
  }

  const float inv_lo = 1.f / fmaxf(l_lo, L_FLOOR);
  const float inv_hi = 1.f / fmaxf(l_hi, L_FLOOR);
  __nv_bfloat16* o_lo = out + ((size_t)b * C + r_lo) * q_row + (size_t)h * HD;
  __nv_bfloat16* o_hi = o_lo + 8 * q_row;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    if (r_lo < C)
      *reinterpret_cast<uint32_t*>(o_lo + 8 * dt + 2 * t) =
          pack_bf16(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    if (r_hi < C)
      *reinterpret_cast<uint32_t*>(o_hi + 8 * dt + 2 * t) =
          pack_bf16(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
  if constexpr (STATS) {
    // the four lanes of a row hold the same (m, l) after the shuffles
    if (t == 0 && r_lo < C) store_stats(m_out, l_out, b, h, H, C, r_lo, m_lo, l_lo);
    if (t == 0 && r_hi < C) store_stats(m_out, l_out, b, h, H, C, r_hi, m_hi, l_hi);
  }
}

// Column masses on CUDA cores (the float32 configs).  One CTA per (64-key
// tile, head, batch), 256 threads laid out as attention_fma's (4 lanes per
// query row, keys c4 + 4j of the tile); the logits are attention_fma's dot
// products in the same order.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
column_masses_fma(const T* __restrict__ q, const T* __restrict__ k,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, float* __restrict__ masses,
                  int C, int H, int K, int KV, int q_offset, int n_total,
                  int window, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;                  // BK x (HD + 1)
  float* sQ = sK + BK * (HD + 1);    // BQ x (HD + 1)
  float* sRed = sQ + BQ * (HD + 1);  // 8 warps x BK
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid >> 2, c4 = tid & 3;
  float* mb = masses + ((size_t)b * H + h) * K;
  int r_begin, r_end;
  counted_rows(k0, BK, C, q_offset, n_total, window, &r_begin, &r_end);
  if (r_begin >= r_end) {  // no counted row sees this tile: exact zeros
    for (int c = tid; c < BK; c += THREADS)
      if (k0 + c < K) mb[k0 + c] = 0.f;
    return;
  }
  const size_t q_row = (size_t)H * HD;
  const size_t k_row = (size_t)KV * HD;
  const T* qb = q + (size_t)b * C * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * K * k_row + (size_t)kvh * HD;
  const float* ms = m_in + ((size_t)b * H + h) * C;
  const float* ls = l_in + ((size_t)b * H + h) * C;
  for (int i = tid; i < BK * HD; i += THREADS) {
    const int c = i / HD, d = i % HD;
    sK[c * (HD + 1) + d] =
        (k0 + c < K) ? to_f32(kb[(size_t)(k0 + c) * k_row + d]) : 0.f;
  }
  float col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = 0.f;
  for (int q0 = (r_begin / BQ) * BQ; q0 < r_end; q0 += BQ) {
    __syncthreads();  // sK staged / the previous row tile's readers done
    for (int i = tid; i < BQ * HD; i += THREADS) {
      const int rr = i / HD, d = i % HD;
      sQ[rr * (HD + 1) + d] =
          (q0 + rr < C) ? to_f32(qb[(size_t)(q0 + rr) * q_row + d]) : 0.f;
    }
    __syncthreads();
    const int row = q0 + r;
    if (row < r_begin || row >= r_end) continue;
    const float m = ms[row];
    const float inv_l = 1.f / fmaxf(ls[row], L_FLOOR);
    const int qpos = q_offset + row;
    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = sQ[r * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] += qd * sK[(c4 + 4 * j) * (HD + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kpos = k0 + c4 + 4 * j;
      const bool ok = kpos < K && kpos <= qpos &&
                      (window <= 0 || qpos - kpos < window);
      const float x = ok ? s[j] * scale : NEG_INF;
      col[j] += ok ? expf(x - m) * inv_l : 0.f;
    }
  }
  // sum over the 8 rows of each warp (lanes with the same c4), then warps
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      col[j] += __shfl_xor_sync(0xffffffffu, col[j], o);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) sRed[warp * BK + lane + 4 * j] = col[j];
  }
  __syncthreads();
  if (tid < BK && k0 + tid < K) {
    float tot = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) tot += sRed[w * BK + tid];
    mb[k0 + tid] = tot;
  }
}

// Column masses on tensor cores (bf16).  One CTA per (64-key tile, head,
// batch), 4 warps of 16 query rows; the key tile stays in shared memory
// while 64-row tiles of Q stream through a cp.async ring, and each warp
// forms S = Q K^T with attention_mma's fragments in its k-step order.
template <int HD>
__global__ void __launch_bounds__(MTHREADS)
column_masses_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, float* __restrict__ masses,
                  int C, int H, int K, int KV, int q_offset, int n_total,
                  int window, float scale) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;
  constexpr int NT = BK / 8;
  constexpr int QT = BQ * LD;  // halves of one Q stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BK x LD
  __nv_bfloat16* sQ = sK + BK * LD;  // 2 stages x BQ x LD
  __shared__ float sRed[MTHREADS / 32][BK];

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* mb = masses + ((size_t)b * H + h) * K;
  int r_begin, r_end;
  counted_rows(k0, BK, C, q_offset, n_total, window, &r_begin, &r_end);
  if (r_begin >= r_end) {  // no counted row sees this tile: exact zeros
    for (int c = tid; c < BK; c += MTHREADS)
      if (k0 + c < K) mb[k0 + c] = 0.f;
    return;
  }
  const size_t q_row = (size_t)H * HD;
  const size_t k_row = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + (size_t)b * C * q_row + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * K * k_row + (size_t)kvh * HD;
  const float* ms = m_in + ((size_t)b * H + h) * C;
  const float* ls = l_in + ((size_t)b * H + h) * C;

#pragma unroll
  for (int it = 0; it < BK * CH / MTHREADS; ++it) {
    const int i = tid + it * MTHREADS;
    const int c = i / CH, ch = i % CH;
    const bool ok = k0 + c < K;
    cp_async16(sK + c * LD + 8 * ch,
               kb + (size_t)(ok ? k0 + c : 0) * k_row + 8 * ch, ok);
  }
  auto load_q = [&](int q0, int stage) {
    __nv_bfloat16* dq = sQ + stage * QT;
#pragma unroll
    for (int it = 0; it < BQ * CH / MTHREADS; ++it) {
      const int i = tid + it * MTHREADS;
      const int rr = i / CH, ch = i % CH;
      const bool ok = q0 + rr < C;
      cp_async16(dq + rr * LD + 8 * ch,
                 qb + (size_t)(ok ? q0 + rr : 0) * q_row + 8 * ch, ok);
    }
    cp_async_commit();
  };
  const int first = (r_begin / BQ) * BQ;
  const int n_tiles = (r_end - first + BQ - 1) / BQ;
  load_q(first, 0);  // one group with the K tile

  float col[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) col[j][0] = col[j][1] = 0.f;
  const int wr = warp * 16;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = first + it * BQ;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_q(q0 + BQ, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this Q tile (and the K tile) landed for every thread
    const __nv_bfloat16* tQ = sQ + stage * QT;
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* p = tQ + (wr + g) * LD + 16 * kk + 2 * t;
      qa[kk][0] = ld32(p);
      qa[kk][1] = ld32(p + 8 * LD);
      qa[kk][2] = ld32(p + 8);
      qa[kk][3] = ld32(p + 8 * LD + 8);
    }
    const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
    const bool v_lo = r_lo >= r_begin && r_lo < r_end;
    const bool v_hi = r_hi >= r_begin && r_hi < r_end;
    const float m_lo = v_lo ? ms[r_lo] : 0.f, m_hi = v_hi ? ms[r_hi] : 0.f;
    const float il_lo = v_lo ? 1.f / fmaxf(ls[r_lo], L_FLOOR) : 0.f;
    const float il_hi = v_hi ? 1.f / fmaxf(ls[r_hi], L_FLOOR) : 0.f;
    const int qp_lo = q_offset + r_lo, qp_hi = q_offset + r_hi;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* p = sK + (8 * j + g) * LD + 16 * kk + 2 * t;
        mma_bf16(s, qa[kk], ld32(p), ld32(p + 8));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kp = k0 + 8 * j + 2 * t + i;
        const bool a = v_lo && kp < K && kp <= qp_lo &&
                       (window <= 0 || qp_lo - kp < window);
        const bool c = v_hi && kp < K && kp <= qp_hi &&
                       (window <= 0 || qp_hi - kp < window);
        const float x_lo = a ? s[i] * scale : NEG_INF;
        const float x_hi = c ? s[2 + i] * scale : NEG_INF;
        col[j][i] += (a ? expf(x_lo - m_lo) * il_lo : 0.f) +
                     (c ? expf(x_hi - m_hi) * il_hi : 0.f);
      }
    }
    __syncthreads();  // every warp is done with `stage` before its refill
  }
  // sum over the 8 row groups g of the warp, then over the warps
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        col[j][i] += __shfl_xor_sync(0xffffffffu, col[j][i], o);
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sRed[warp][8 * j + 2 * t] = col[j][0];
      sRed[warp][8 * j + 2 * t + 1] = col[j][1];
    }
  }
  __syncthreads();
  if (tid < BK && k0 + tid < K) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < MTHREADS / 32; ++w) tot += sRed[w][tid];
    mb[k0 + tid] = tot;
  }
}

template <typename Entry, typename T, int HD, bool CAUSAL, bool STATS = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int C, int H, int K, int KV, int q_offset,
                   int window, cudaStream_t stream, float* m_out = nullptr,
                   float* l_out = nullptr, const uint8_t* kv_mask = nullptr) {
  dim3 grid((C + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)HD);
  if constexpr (sizeof(T) == 2) {  // bf16: tensor cores
    const int smem = (BQ + 4 * BK) * (HD + 8) * 2;
    auto* kern = attention_mma<Entry, HD, CAUSAL, STATS>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, MTHREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, m_out, l_out, kv_mask,
        C, H, K, KV, q_offset, window, scale);
  } else {  // fp32: CUDA cores
    const int smem = (BQ * (HD + 1) + BK * (HD + 1) + BK * HD) * sizeof(float);
    auto* kern = attention_fma<Entry, T, HD, CAUSAL, STATS>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, m_out, l_out,
        kv_mask, C, H, K, KV, q_offset, window, scale);
  }
  return cudaGetLastError();
}

// Kernel 2: (a) the chunk attention with its row statistics, then (b) the
// column masses from them, on one stream.
template <typename T, int HD>
cudaError_t launch_masses(const void* q, const void* k, const void* v,
                          void* out, float* m_buf, float* l_buf,
                          float* masses, int B, int C, int H, int K, int KV,
                          int q_offset, int n_total, int window,
                          cudaStream_t stream) {
  cudaError_t err = launch<chunk_masses_tag, T, HD, true, true>(
      q, k, v, out, B, C, H, K, KV, q_offset, window, stream, m_buf, l_buf);
  if (err != cudaSuccess) return err;
  dim3 grid((K + BK - 1) / BK, H, B);
  const float scale = 1.f / sqrtf((float)HD);
  if constexpr (sizeof(T) == 2) {
    const int smem = (BK + 2 * BQ) * (HD + 8) * 2;
    auto* kern = column_masses_mma<HD>;
    err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, MTHREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, m_buf, l_buf,
        masses, C, H, K, KV, q_offset, n_total, window, scale);
  } else {
    const int smem =
        ((BK + BQ) * (HD + 1) + (THREADS / 32) * BK) * sizeof(float);
    auto* kern = column_masses_fma<T, HD>;
    err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, m_buf, l_buf, masses, C, H, K, KV,
        q_offset, n_total, window, scale);
  }
  return cudaGetLastError();
}

// The Hopper tile's partials when a query tile's key range is split over
// n_split CTAs (n_split 1: none): o (n_split, B, H, C, hd), m and l
// (n_split, B, H, C) float32, allocated by the caller.
struct Split {
  int n;
  float* o;
  float* m;
  float* l;
};

// Kernel 2: bf16 at hd 64 and 128 on the Hopper tile (attention_sm90 with
// STATS, its split combine if any, then column_masses_sm90), everything
// else on this file's kernels (which take no split).
cudaError_t dispatch_masses(int dtype, int hd, const void* q, const void* k,
                            const void* v, void* out, float* m_buf,
                            float* l_buf, float* masses, int B, int C, int H,
                            int K, int KV, int q_offset, int n_total,
                            int window, Split sp, cudaStream_t s) {
  using tag = chunk_masses_tag;
  const bool sm90 = dtype == DTYPE_BF16 && (hd == 64 || hd == 128);
  if (sp.n != 1 && !sm90) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == DTYPE_F32) {
    switch (hd) {
      case 32: return launch_masses<float, 32>(q, k, v, out, m_buf, l_buf, masses, B, C, H, K, KV, q_offset, n_total, window, s);
      case 64: return launch_masses<float, 64>(q, k, v, out, m_buf, l_buf, masses, B, C, H, K, KV, q_offset, n_total, window, s);
      case 128: return launch_masses<float, 128>(q, k, v, out, m_buf, l_buf, masses, B, C, H, K, KV, q_offset, n_total, window, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != DTYPE_BF16) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_masses<__nv_bfloat16, 32>(q, k, v, out, m_buf, l_buf, masses, B, C, H, K, KV, q_offset, n_total, window, s);
    case 64:
      err = sm90::launch<tag, 64, true, true, true>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, m_buf, l_buf, sp.n, sp.o, sp.m, sp.l);
      if (err != cudaSuccess) return err;
      return sm90::launch_column_masses<64>(q, k, m_buf, l_buf, masses, B, C, H, K, KV, q_offset, n_total, window, s);
    case 128:
      err = sm90::launch<tag, 128, true, true, true>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, m_buf, l_buf, sp.n, sp.o, sp.m, sp.l);
      if (err != cudaSuccess) return err;
      return sm90::launch_column_masses<128>(q, k, m_buf, l_buf, masses, B, C, H, K, KV, q_offset, n_total, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// Kernels 1 and 7: bf16 at hd 64 and 128 on the Hopper tile, everything
// else on this file's kernels (which take no split).  Kernel 7 (SPLIT
// false) fills the card with query tiles and never splits; its key mask
// (kv_mask not null) runs the tile's MASKED instantiations.
template <typename Entry, bool CAUSAL, bool SPLIT>
cudaError_t dispatch(int dtype, int hd, const void* q, const void* k,
                     const void* v, void* out, int B, int C, int H, int K,
                     int KV, int q_offset, int window, Split sp,
                     cudaStream_t s, const uint8_t* kv_mask = nullptr) {
  const bool sm90 = dtype == DTYPE_BF16 && (hd == 64 || hd == 128);
  if (sp.n != 1 && !(sm90 && SPLIT)) return cudaErrorInvalidValue;
  if (kv_mask != nullptr && SPLIT) return cudaErrorInvalidValue;
  if (dtype == DTYPE_F32) {
    switch (hd) {
      case 32: return launch<Entry, float, 32, CAUSAL>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, kv_mask);
      case 64: return launch<Entry, float, 64, CAUSAL>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, kv_mask);
      case 128: return launch<Entry, float, 128, CAUSAL>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, kv_mask);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != DTYPE_BF16) return cudaErrorInvalidValue;
  if constexpr (!SPLIT) {
    if (kv_mask != nullptr && hd == 64)
      return sm90::launch<Entry, 64, CAUSAL, false, false, true>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, 1, nullptr, nullptr, nullptr, kv_mask);
    if (kv_mask != nullptr && hd == 128)
      return sm90::launch<Entry, 128, CAUSAL, false, false, true>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, 1, nullptr, nullptr, nullptr, kv_mask);
  }
  switch (hd) {
    case 32: return launch<Entry, __nv_bfloat16, 32, CAUSAL>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, kv_mask);
    case 64: return sm90::launch<Entry, 64, CAUSAL, false, SPLIT>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, sp.n, sp.o, sp.m, sp.l);
    case 128: return sm90::launch<Entry, 128, CAUSAL, false, SPLIT>(q, k, v, out, B, C, H, K, KV, q_offset, window, s, nullptr, nullptr, sp.n, sp.o, sp.m, sp.l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no window.  n_split > 1 (bf16 at hd 64 and 128 only)
// splits each query tile's key range over n_split CTAs, with the float32
// scratch of Split.  Returns cudaGetLastError() after the last launch.
extern "C" int chunk_attention(const void* q, const void* k, const void* v,
                               void* out, void* o_part, void* m_part,
                               void* l_part, int B, int C, int H, int K,
                               int KV, int hd, int q_offset, int window,
                               int n_split, int dtype, void* stream) {
  const Split sp{n_split, (float*)o_part, (float*)m_part, (float*)l_part};
  return dispatch<chunk_attention_tag, true, true>(dtype, hd, q, k, v, out,
                                                   B, C, H, K, KV, q_offset,
                                                   window, sp,
                                                   (cudaStream_t)stream);
}

// Self-attention of a whole sequence: q (B, S, H, hd), k/v (B, S, KV, hd).
// causal != 0: row i sees keys 0..i; causal == 0: every key.  window <= 0
// means no window.  kv_mask (B, S) bytes or null: a key whose byte is 0 is
// hidden from every row.  Returns cudaGetLastError() after launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* kv_mask, void* out, int B, int S,
                               int H, int KV, int hd, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using tag = flash_attention_tag;
  const Split one{1, nullptr, nullptr, nullptr};
  const uint8_t* mask = (const uint8_t*)kv_mask;
  if (causal)
    return dispatch<tag, true, false>(dtype, hd, q, k, v, out, B, S, H, S, KV, 0, window, one, s, mask);
  return dispatch<tag, false, false>(dtype, hd, q, k, v, out, B, S, H, S, KV, 0, window, one, s, mask);
}

// Chunk attention plus the column masses of the rows below n_total (h2o):
// out as the entry chunk_attention (the same split), masses (B, H, K)
// float32; m_buf and l_buf are (B, H, C) float32 scratch.  window <= 0
// means no window.  Returns cudaGetLastError() after the last launch.
extern "C" int chunk_attention_masses(const void* q, const void* k,
                                      const void* v, void* out, void* m_buf,
                                      void* l_buf, void* masses,
                                      void* o_part, void* m_part,
                                      void* l_part, int B, int C, int H,
                                      int K, int KV, int hd, int q_offset,
                                      int n_total, int window, int n_split,
                                      int dtype, void* stream) {
  const Split sp{n_split, (float*)o_part, (float*)m_part, (float*)l_part};
  return dispatch_masses(dtype, hd, q, k, v, out, (float*)m_buf,
                         (float*)l_buf, (float*)masses, B, C, H, K, KV,
                         q_offset, n_total, window, sp, (cudaStream_t)stream);
}
