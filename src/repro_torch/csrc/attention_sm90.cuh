// Attention tile for Hopper (sm_90a): wgmma for both products, a TMA +
// mbarrier ring for K/V.  bf16 in, f32 accumulate, bf16 out; head dims 64,
// 128 and 256.
//
// Computes C query rows at absolute positions q_offset.. attending over a
// K-deep key/value buffer whose column j holds position j; earlier columns
// are visible, the rows are causal among themselves (CAUSAL), and an
// optional window hides keys with q_pos - k_pos >= window.  Three entries
// of chunk_attention.cu run it at bf16 with head dims 64, 128 and 256:
// * chunk_attention (kernel 1, the port of chunk_attention_pallas of
//   src/repro/kernels/chunk_attention.py): a prefill chunk or the 32-row
//   observation pass at q_offset over the buffer;
// * flash_attention (kernel 7, flash_attention_pallas of
//   src/repro/kernels/flash_attention.py): q_offset 0 and C == K, or
//   non-causal with C != K (whisper's cross-attention: the Q and O maps
//   span C rows, the K/V maps K keys, every query tile runs all key
//   tiles and the ragged last one is masked);
// * chunk_attention_masses (kernel 2, chunk_attention_masses_pallas): the
//   tile with STATS, which adds only a store of each row's final (m, l),
//   so its out is bitwise kernel 1's, then column_masses_sm90 below.
//
// Layout: q (B, C, H, hd), k/v (B, K, KV, hd) contiguous bf16, out (B, C,
// H, hd).  GQA: query head h reads kv head h / (H / KV).
//
// Design.  One CTA per (128-row query tile, q head, batch), the last tile
// first (the longest causal key loops start first): two consumer
// warpgroups of 64 rows each and one producer warpgroup (384 threads, one
// CTA per SM).  The producer drops to 24 registers (setmaxnreg) and one
// of its threads issues every load; the consumers take 240.
// * Loads by TMA through 4-D tensor maps (hd, heads, rows, batch), so the
//   tail past a sequence's last row reads zeros, never the next
//   sequence's rows.  Every tile is stored with the 128-byte swizzle in
//   64-column halves (a TMA box with that swizzle is at most 128 bytes
//   wide): 128 rows x 128 bytes = 16 KB per half, 1024-byte aligned.  Q
//   comes in once; tiles of K and V go through a ring (Geom): 128 keys
//   and 3 stages at hd 64 and 128 (113 and 225 KB of shared memory), 64
//   keys and 2 stages at hd 256 (193 KB; 128-key tiles in 3 stages would
//   take 449 KB of the card's 227), each stage with a `full` mbarrier that
//   the TMA transaction completes and an `empty` one that the 256 consumer
//   threads arrive on once done with it.
// * S = Q.K^T: wgmma m64n128k16 (m64n64k16 on hd 256's 64-key tiles), both
//   operands read from shared memory by descriptor (K-major: hd contiguous
//   in both Q and K), hd/16 k-steps.
// * Mask in registers (only on tiles that need it: the causal diagonal,
//   the window's edge, the ragged key tail, whose zero-filled keys would
//   give logit 0, and with a key mask a tile that holds a masked key),
//   then the online softmax in f32 with exp2 and the scale times log2(e)
//   folded in.  P is rounded to bf16 in registers.
// * Key mask (MASKED, kernel 7's bucket-padded prefill: kv_mask (B, K)
//   bytes, nonzero = a valid key).  Before the roles split, each warp of
//   the CTA reads the mask bytes of some of the CTA's key tiles and sets
//   two bits per tile in shared memory: "holds a valid key" and "holds a
//   masked key".  A consumer skips both products of a tile with no valid
//   key (it still arrives on the tile's `empty` barrier, so the ring's
//   phases are those of the unmasked kernel) and masks in registers only
//   on a tile that holds a masked key.  Masked logits are -inf.  A row may
//   now meet a tile while its running max is still -inf (key 0 masked):
//   the max then stays -inf, its rescale factor and probabilities are
//   exp2(-inf) = 0 against a zero offset, and a row that never sees a
//   valid key stores zeros (l = 0 under L_FLOOR), never NaN.  The
//   instantiations without MASKED compile none of this.
// * O += P.V: wgmma m64n{hd}k16 with A = P from registers (the S
//   accumulator layout is the A-fragment layout of the next product: pack
//   adjacent pairs to bf16x2) and B = V read as MN-major from shared
//   memory (V is key-major with hd contiguous: transpose flag 1).  At hd
//   256 two m64n128k16 products per k-step, one per 128-column half of O;
//   O is then 128 float32 registers a consumer thread, S 32 (64 keys) and
//   P 16, under the 240 that setmaxnreg gives.
// * Epilogue: O / max(l, L_FLOOR) to bf16, rows < C only.  With STATS,
//   lane t == 0 of each row also stores the row's raw logit max m (not
//   scaled) and l in this tile's units: l = sum_j exp2(s_j * scale_log2 -
//   m * scale_log2), the product m * scale_log2 rounded once to float.
//
// Bound on the H100 (989 TFLOP/s bf16): operations, 4*hd*H*sum_i(visible
// keys of row i), ~0.14 ms for llama3-8b's 4 x 2080-row causal prefill,
// ~0.017 ms for its 256-row chunk at offset 3840 of a 4096-deep buffer;
// under a key mask only the valid visible keys count (~0.032 ms for the
// padded 4 x 1024 group of prompts of 512 / 700 / 900 / 1024 tokens).
// What it leaves: the softmax of a tile does not overlap its own
// warpgroup's products (no ping-pong between the two warpgroups, no next
// S issued before this P.V), a warpgroup computes whole 128-key tiles on
// the causal diagonal, and the output is stored from registers.
//
// Key splits.  A short chunk makes few CTAs: a 256-row chunk of one
// sequence is 2 x H (64 for llama3-8b on 132 SMs), the 32-row observation
// pass H with one warpgroup idle.  With n_split > 1 (the caller picks it,
// kernels/chunk_attention.py: key_splits) each query tile's key tiles are
// shared out, balanced, over n_split CTAs (grid.x = tiles x n_split); each
// stores its unnormalised float32 (o, m, l) and combine_splits merges them
// in split order, so the result does not depend on which CTA ran first.
// Kernels 1 and 2 take the same split, so kernel 2's out stays bitwise
// kernel 1's, and kernel 2's (m, l) are the merged ones.
//
// column_masses_sm90 (kernel 2's second launch): one CTA per (128-key
// tile, q head, batch) loads its K tile once and streams the 128-row Q
// tiles of the counted rows through a 2-stage TMA ring.  The Q and K tiles
// sit where the attention tile's do (Q tiles 128-aligned from row 0, key
// tiles 128-aligned from position 0, the same swizzled halves), and S
// comes from the same wgmma calls in the same k-step order, so each logit
// is bitwise the one the attention tile's softmax saw; p = exp2(s *
// scale_log2 - m * scale_log2) / max(l, L_FLOOR) is then at most ~1.  At
// hd 256 this launch keeps 128-key tiles (K 64 KB, two 64 KB Q stages, 193
// KB): its m64n128k16 products run the tile's k-steps in the same order
// over twice the tile's m64n64k16 width.
// Column sums go over the lane's two rows and its Q tiles in registers,
// then the 8 row lanes by shuffles, then the 8 warps through shared memory,
// each in a fixed order: no atomics, deterministic masses.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link: see below)
#include <math.h>

#include "common.cuh"

namespace sm90 {

constexpr int BM = 128;       // query rows per CTA (two warpgroups of 64)
constexpr int BN = 128;       // keys per tile of column_masses_sm90
constexpr int CONSUMERS = 256;  // two warpgroups: the products and softmax
constexpr int THREADS = CONSUMERS + 128;  // a third warpgroup loads
constexpr int QSTAGES = 2;    // Q ring depth of column_masses_sm90
constexpr int HALF = BM * 128;  // bytes of one 64-column half of a Q tile

// The attention tile's K/V budget per head dim: keys per K/V tile and ring
// depth.  hd 64 and 128: 128-key tiles through 3 stages (113 and 225 KB
// with Q); hd 256: 64-key tiles through 2 stages, Q 64 KB and the ring
// 2 x (K + V) x 32 KB, 193 KB (3 stages of 128 keys would take 449 KB).
template <int HD>
struct Geom {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head dims 64-256");
  static constexpr int BN = HD == 256 ? 64 : 128;
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr int QTILE = (HD / 64) * HALF;  // bytes of the Q tile
  static constexpr int KHALF = BN * 128;  // one 64-column half of K or V
  static constexpr int KTILE = (HD / 64) * KHALF;  // bytes of a K or V tile
  // the alignment pad, Q, STAGES x (K, V)
  static constexpr int SMEM = 1024 + QTILE + 2 * STAGES * KTILE;
  static_assert(SMEM <= 232448, "a CTA's shared memory");
};

// softmax scale times log2(e), the same float in both launches of kernel 2
inline float log2e_scale(int hd) {
  return 1.4426950408889634f / sqrtf((float)hd);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// lasts ~2^34 cycles (~9 s) traps, so a broken ring fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// -- TMA ---------------------------------------------------------------------
// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory at `dst`, completing `bytes` of the transaction on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
//   K-major (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
//     LBO unused; a k-step of 16 columns advances the start by 32 bytes.
//   MN-major (V as B of P.V): 8-key groups 1024 bytes apart (SBO), the two
//     64-column halves of hd 128 one HALF apart (LBO); a k-step of 16 keys
//     advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes to this point of
// the instruction stream, so the compiler neither reads an accumulator
// before its wait nor reuses an A register while the product runs.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 128, f32) += A (64 x 16, shared, K-major) . B (128 x 16, shared,
// K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// D (64 x 64, f32) += A (64 x 16, shared, K-major) . B (64 x 16, shared,
// K-major): S of a 64-key tile (hd 256).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, shared,
// MN-major: N contiguous), D being registers OFF.. OFF + 63 of d: at hd 256
// the O accumulator's two 128-column halves (OFF 0 and 64) take one each.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator range");
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major: N contiguous).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Thread 0: the K and V boxes of key tile `k0` into the stage at `dk` (V
// one tile after K), completing on `bar`.
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t dk,
                                        uint32_t bar, int kvh, int k0, int b) {
  using G = Geom<HD>;
  mbar_expect_tx(bar, 2 * G::KTILE);  // whole boxes, the zero fill included
#pragma unroll
  for (int hf = 0; hf < HD / 64; ++hf) {
    tma_load(dk + hf * G::KHALF, tk, bar, 64 * hf, kvh, k0, b);
    tma_load(dk + G::KTILE + hf * G::KHALF, tv, bar, 64 * hf, kvh, k0, b);
  }
}

// Accumulator layout of wgmma m64nN (f32) in warp w of a warpgroup, lane
// (g = lane / 4, t = lane % 4): register 4j + e holds row 16w + g + 8(e/2),
// column 8j + 2t + e%2.  The A-register layout of m64k16 (bf16x2) is the
// same for 16 columns: (row g, cols 2t..), (g + 8, 2t..), (g, 8 + 2t..),
// (g + 8, 8 + 2t..), so the S registers 8kk..8kk+7, packed in pairs, are
// P's A fragment of k-step kk.
// Key tiles a masked call may span: 2048 tiles, K <= 262,144 at hd 64 and
// 128 and 131,072 at hd 256 (kernels/flash_attention.py checks it).
constexpr int MASK_WORDS = 64;

template <typename Entry, int HD, bool CAUSAL, bool STATS, bool SPLIT,
          bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
attention_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ o_part,
               float* __restrict__ m_part, float* __restrict__ l_part,
               const uint8_t* __restrict__ kv_mask, int n_split_arg, int C,
               int H, int K, int KV, int q_offset, int window,
               float scale_log2) {
  using G = Geom<HD>;
  constexpr int BN = G::BN, STAGES = G::STAGES;  // keys per tile, ring depth
  constexpr int KTILE = G::KTILE;
  // an instantiation without SPLIT (kernel 7's) compiles the split away
  const int n_split = SPLIT ? n_split_arg : 1;
  constexpr int NO = HD / 2;              // O registers per thread
  extern __shared__ unsigned char smem_raw[];
  // q, full[STAGES], empty[STAGES]
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  // MASKED: bit i of word i / 32 of the first MASK_WORDS: this CTA's key
  // tile i holds a valid key; of the next MASK_WORDS: it holds a masked one
  __shared__ uint32_t tile_bits[MASKED ? 2 * MASK_WORDS : 1];
  // TMA destinations with the 128-byte swizzle need 1024-byte alignment
  // stage s: K at sQ + QTILE + 2s KTILE, V right after it
  const uint32_t sQ = (saddr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = saddr(&bars[0]);
  auto sK = [=](int s) { return sQ + G::QTILE + 2 * s * KTILE; };
  auto full = [=](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [=](int s) { return bar_q + 8 * (1 + STAGES + s); };

  // query tile (the last one first) and this CTA's split of its key range
  const int n_qt = gridDim.x / n_split;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / n_split) * BM;
  const int split = blockIdx.x % n_split;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int rows = min(BM, C - q0);
  // past the last visible key; with a window, the first tile any row sees
  const int k_end = CAUSAL ? min(K, q_offset + q0 + rows) : K;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_offset + q0 - window + 1) / BN) * BN;
  // this split's key tiles: it0.. of the query tile's n_all, balanced;
  // a split may get none (it stores m = -inf, l = 0, o = 0)
  const int n_all = (k_end - k_begin + BN - 1) / BN;
  const int it0 = split * n_all / n_split;
  const int n_tiles = (split + 1) * n_all / n_split - it0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (MASKED) {
    for (int i = tid; i < 2 * MASK_WORDS; i += THREADS) tile_bits[i] = 0;
    __syncthreads();
    // one warp per key tile: 4 mask bytes a lane, keys past K ignored
    const uint8_t* mb = kv_mask + (size_t)b * K;
    for (int i = tid >> 5; i < n_tiles; i += THREADS / 32) {
      const int kt = k_begin + (it0 + i) * BN;
      bool valid = false, masked = false;
      for (int c = lane; c < BN; c += 32) {
        if (kt + c < K) {
          if (mb[kt + c]) valid = true;
          else masked = true;
        }
      }
      valid = __any_sync(0xffffffffu, valid);
      masked = __any_sync(0xffffffffu, masked);
      if (lane == 0) {
        if (valid) atomicOr(&tile_bits[i >> 5], 1u << (i & 31));
        if (masked) atomicOr(&tile_bits[MASK_WORDS + (i >> 5)], 1u << (i & 31));
      }
    }
  }
  __syncthreads();  // the last barrier of all 384 threads: the roles split

  if (wg == 2) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_q, G::QTILE);
#pragma unroll
      for (int hf = 0; hf < HD / 64; ++hf)
        tma_load(sQ + hf * HALF, &tq, bar_q, 64 * hf, h, q0, b);
      int s = 0;
      uint32_t phase = 0;  // parity of this pass over the ring
      for (int it = 0; it < n_tiles; ++it) {
        // the consumers are done with this slot's previous tile
        if (it >= STAGES) mbar_wait(empty(s), phase ^ 1);
        load_kv<HD>(&tk, &tv, sK(s), full(s), kvh,
                    k_begin + (it0 + it) * BN, b);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // this warpgroup's rows: positions wr0..wr0+63; this lane's two rows
  const int wr0 = q_offset + q0 + 64 * wg;
  const bool wg_live = q0 + 64 * wg < C;
  const int r_lo = q0 + 64 * wg + 16 * warp + g, r_hi = r_lo + 8;
  const int qp_lo = q_offset + r_lo, qp_hi = q_offset + r_hi;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const uint64_t dq = desc_sw128(sQ + wg * 64 * 128, 16, 1024);

  mbar_wait(bar_q, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + (it0 + it) * BN;
    mbar_wait(full(s), phase);
    // does any row of this warpgroup see a key of this tile?
    bool vis = wg_live && (!CAUSAL || k0 <= wr0 + 63) &&
               (window <= 0 || wr0 - (k0 + BN - 1) < window);
    bool some_masked = false;
    if constexpr (MASKED) {
      vis = vis && ((tile_bits[it >> 5] >> (it & 31)) & 1u);
      some_masked = (tile_bits[MASK_WORDS + (it >> 5)] >> (it & 31)) & 1u;
    }
    if (vis) {
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // k-step kk: 16 columns into the 64-column half kk / 4 of Q and K
        const uint32_t qoff = (kk >> 2) * HALF + (kk & 3) * 32;
        const uint64_t dk =
            desc_sw128(sK(s) + (kk >> 2) * G::KHALF + (kk & 3) * 32, 16, 1024);
        if constexpr (BN == 128)
          wgmma_ss_n128(sc, dq + (qoff >> 4), dk);
        else
          wgmma_ss_n64(sc, dq + (qoff >> 4), dk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask only where some (row, key) pair of the tile is hidden
      const bool edge = (CAUSAL && k0 + BN - 1 > wr0) || k0 + BN > K ||
                        (window > 0 && wr0 + 63 - k0 >= window) ||
                        some_masked;
      if (edge) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          // the two keys of this lane in column block j, and their bytes
          bool key_ok[2] = {true, true};
          if constexpr (MASKED) {
            const uint8_t* mb = kv_mask + (size_t)b * K;
            const int kp0 = k0 + 8 * j + 2 * t;
            key_ok[0] = kp0 < K && mb[kp0];
            key_ok[1] = kp0 + 1 < K && mb[kp0 + 1];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const int qp = e < 2 ? qp_lo : qp_hi;
            const bool ok = kp < K && (!CAUSAL || kp <= qp) &&
                            (window <= 0 || qp - kp < window) &&
                            key_ok[e & 1];
            if (!ok) sc[4 * j + e] = -INFINITY;
          }
        }
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
      }
      // a row that has seen nothing yet (its max still -inf: no key so
      // far, or only masked ones) keeps exact zeros: it rescales by
      // exp2(-inf - 0) = 0 and its probabilities are exp2(-inf) = 0
      const float ms_lo = mx_lo == -INFINITY ? 0.f : mx_lo * scale_log2;
      const float ms_hi = mx_hi == -INFINITY ? 0.f : mx_hi * scale_log2;
      const float c_lo = ex2(m_lo * scale_log2 - ms_lo);
      const float c_hi = ex2(m_hi * scale_log2 - ms_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      // l is this lane's partial row sum; the quad adds them at the end
      l_lo *= c_lo;
      l_hi *= c_hi;
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          p[e] = ex2(fmaf(sc[8 * kk + e], scale_log2,
                          (e & 2) ? -ms_hi : -ms_lo));
        l_lo += (p[0] + p[1]) + (p[4] + p[5]);
        l_hi += (p[2] + p[3]) + (p[6] + p[7]);
        pa[kk][0] = pack2(p[0], p[1]);
        pa[kk][1] = pack2(p[2], p[3]);
        pa[kk][2] = pack2(p[4], p[5]);
        pa[kk][3] = pack2(p[6], p[7]);
      }
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        o[4 * i] *= c_lo;
        o[4 * i + 1] *= c_lo;
        o[4 * i + 2] *= c_hi;
        o[4 * i + 3] *= c_hi;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // V's 16 keys of k-step kk, N over its 64-column halves (LBO)
        const uint32_t va = sK(s) + KTILE + kk * 16 * 128;
        const uint64_t dv = desc_sw128(va, G::KHALF, 1024);
        if constexpr (HD == 256) {  // two 128-column products
          wgmma_rs_n128<0>(o, pa[kk], dv);
          wgmma_rs_n128<64>(o, pa[kk],
                            desc_sw128(va + 2 * G::KHALF, G::KHALF, 1024));
        } else if constexpr (HD == 128) {
          wgmma_rs_n128<0>(o, pa[kk], dv);
        } else {
          wgmma_rs_n64(o, pa[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }
    mbar_arrive(empty(s));  // this thread is done with stage s
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o2);
  }
  if (n_split > 1) {  // this split's unnormalised (o, m, l) for the combine
    const size_t w_lo = (((size_t)split * gridDim.z + b) * H + h) * C + r_lo;
    if (t == 0 && r_lo < C) {
      m_part[w_lo] = m_lo;
      l_part[w_lo] = l_lo;
    }
    if (t == 0 && r_hi < C) {
      m_part[w_lo + 8] = m_hi;
      l_part[w_lo + 8] = l_hi;
    }
    float* p_lo = o_part + w_lo * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (r_lo < C)
        *reinterpret_cast<float2*>(p_lo + 8 * j + 2 * t) =
            make_float2(o[4 * j], o[4 * j + 1]);
      if (r_hi < C)
        *reinterpret_cast<float2*>(p_lo + 8 * HD + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    return;
  }
  if constexpr (STATS) {  // (B, H, C) scratch for column_masses_sm90
    const size_t st = ((size_t)b * H + h) * C;
    if (t == 0 && r_lo < C) {
      m_out[st + r_lo] = m_lo;
      l_out[st + r_lo] = l_lo;
    }
    if (t == 0 && r_hi < C) {
      m_out[st + r_hi] = m_hi;
      l_out[st + r_hi] = l_hi;
    }
  }
  const float i_lo = 1.f / fmaxf(l_lo, L_FLOOR);
  const float i_hi = 1.f / fmaxf(l_hi, L_FLOOR);
  const size_t row = (size_t)H * HD;
  __nv_bfloat16* o_lo = out + ((size_t)b * C + r_lo) * row + (size_t)h * HD;
  __nv_bfloat16* o_hi = o_lo + 8 * row;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r_lo < C)
      *reinterpret_cast<uint32_t*>(o_lo + 8 * j + 2 * t) =
          pack2(o[4 * j] * i_lo, o[4 * j + 1] * i_lo);
    if (r_hi < C)
      *reinterpret_cast<uint32_t*>(o_hi + 8 * j + 2 * t) =
          pack2(o[4 * j + 2] * i_hi, o[4 * j + 3] * i_hi);
  }
}

// cuTensorMapEncodeTiled is a driver-API function and the libraries link
// only the runtime, so it is looked up through the runtime once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, rows, heads, hd) bf16 tensor as a 4-D map (hd, heads, rows, B) with
// boxes of 64 columns x 1 head x box_rows rows x 1 sequence, 128-byte
// swizzle; rows past `rows` read as zeros.
static cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int hd,
                              int heads, int rows, int B, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Merge the n_split partial (o, m, l) of each (b, h, row) in split order
// (deterministic): out = sum_s o_s c_s / max(sum_s l_s c_s, L_FLOOR) with
// c_s = exp2(m_s * scale_log2 - m * scale_log2), m = max_s m_s; with m_out,
// also the merged (m, l) in the tile's units.  One warp per row of a head,
// HD / 32 columns per lane.  Entry is the calling entry's tag, so a
// profile counts the merge with the kernel it finishes.
template <typename Entry, int HD>
__global__ void __launch_bounds__(256)
combine_splits(const float* __restrict__ o_part,
               const float* __restrict__ m_part,
               const float* __restrict__ l_part,
               __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, int B, int C, int H, int n_split,
               float scale_log2) {
  constexpr int V = HD / 32;
  const size_t plane = (size_t)B * H * C;
  const size_t w = (size_t)blockIdx.x * 8 + (threadIdx.x >> 5);  // (b, h, row)
  if (w >= plane) return;
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_part[s * plane + w]);
  const float ms = m == -INFINITY ? 0.f : m * scale_log2;
  float l = 0.f, o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float c = ex2(m_part[s * plane + w] * scale_log2 - ms);
    l += l_part[s * plane + w] * c;
    const float* src = o_part + (s * plane + w) * HD + V * lane;
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] += src[i] * c;
  }
  const int row = (int)(w % C), h = (int)(w / C % H), b = (int)(w / C / H);
  const float inv = 1.f / fmaxf(l, L_FLOOR);
  __nv_bfloat16* dst = out + (((size_t)b * C + row) * H + h) * HD + V * lane;
#pragma unroll
  for (int i = 0; i < V; i += 2)
    *reinterpret_cast<uint32_t*>(dst + i) = pack2(o[i] * inv, o[i + 1] * inv);
  if (m_out != nullptr && lane == 0) {
    m_out[w] = m;
    l_out[w] = l;
  }
}

// q (B, C, H, HD), k/v (B, K, KV, HD) bf16 -> out (B, C, H, HD); window <= 0
// means no window; with STATS each row's (m, l) into the (B, H, C) float32
// m_out, l_out.  With SPLIT, n_split > 1 runs each query tile's key range
// on n_split CTAs that store float32 partials into o_part (n_split, B, H,
// C, HD) and m_part, l_part (n_split, B, H, C), then merges them
// (combine_splits).  With MASKED, kv_mask (B, K) bytes hide the keys
// whose byte is 0 from every row (K <= 262,144).
// Returns the first error (map encoding or launch).
template <typename Entry, int HD, bool CAUSAL, bool STATS = false,
          bool SPLIT = false, bool MASKED = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int C, int H, int K, int KV, int q_offset,
                   int window, cudaStream_t stream, float* m_out = nullptr,
                   float* l_out = nullptr, int n_split = 1,
                   float* o_part = nullptr, float* m_part = nullptr,
                   float* l_part = nullptr,
                   const uint8_t* kv_mask = nullptr) {
  using G = Geom<HD>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, HD, H, C, B, BM);
  if (err == cudaSuccess) err = tensor_map(&tk, k, HD, KV, K, B, G::BN);
  if (err == cudaSuccess) err = tensor_map(&tv, v, HD, KV, K, B, G::BN);
  if (err != cudaSuccess) return err;
  const int smem = G::SMEM;
  auto* kern = attention_sm90<Entry, HD, CAUSAL, STATS, SPLIT, MASKED>;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  if (n_split < 1 || (n_split > 1 && (!SPLIT || o_part == nullptr)))
    return cudaErrorInvalidValue;
  if (MASKED != (kv_mask != nullptr) ||
      (MASKED && K > MASK_WORDS * 32 * G::BN))
    return cudaErrorInvalidValue;
  dim3 grid((C + BM - 1) / BM * n_split, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, m_out, l_out, o_part, m_part, l_part,
      kv_mask, n_split, C, H, K, KV, q_offset, window, log2e_scale(HD));
  if constexpr (SPLIT) {  // kernel 7 never splits: no merge instantiated
    if (n_split == 1) return cudaGetLastError();
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t rows = (size_t)B * H * C;
    combine_splits<Entry, HD><<<(unsigned)((rows + 7) / 8), 256, 0,
                                stream>>>(
        o_part, m_part, l_part, (__nv_bfloat16*)out, STATS ? m_out : nullptr,
        l_out, B, C, H, n_split, log2e_scale(HD));
  }
  return cudaGetLastError();
}

// Kernel 2's second launch: masses[b, h, j] for the keys j of tile
// blockIdx.x, summed over the counted rows, from the (m, l) that
// attention_sm90 with STATS stored.  256 threads (two warpgroups of 64
// rows); thread 0 issues the loads: the K tile once, the Q tiles through a
// QSTAGES ring that it refills once all 256 threads have left a stage.
template <int HD>
__global__ void __launch_bounds__(CONSUMERS)
column_masses_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const float* __restrict__ m_in,
                   const float* __restrict__ l_in,
                   float* __restrict__ masses, int C, int H, int K, int KV,
                   int q_offset, int n_total, int window, float scale_log2) {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head dims 64-256");
  constexpr int TILE = (HD / 64) * HALF;  // a 128-row Q or K tile
  extern __shared__ unsigned char smem_raw[];
  // k, full[QSTAGES], empty[QSTAGES]
  __shared__ __align__(8) uint64_t bars[1 + 2 * QSTAGES];
  __shared__ float red[CONSUMERS / 32][BN];  // per-warp column sums
  // the K tile, then Q stage s at sK + (1 + s) TILE
  const uint32_t sK = (saddr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_k = saddr(&bars[0]);
  auto sQ = [=](int s) { return sK + (1 + s) * TILE; };
  auto full = [=](int s) { return bar_k + 8 * (1 + s); };
  auto empty = [=](int s) { return bar_k + 8 * (1 + QSTAGES + s); };

  const int k0 = blockIdx.x * BN;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* mb = masses + ((size_t)b * H + h) * K;
  int r_begin, r_end;
  counted_rows(k0, BN, C, q_offset, n_total, window, &r_begin, &r_end);
  if (r_begin >= r_end) {  // no counted row sees this tile: exact zeros
    if (tid < BN && k0 + tid < K) mb[k0 + tid] = 0.f;
    return;
  }
  // Q tiles where the attention tile has them: 128-aligned from row 0
  const int first = (r_begin / BM) * BM;
  const int n_qt = (r_end - first + BM - 1) / BM;
  const CUtensorMap* pq = &tq;
  auto load_q = [=](int s, int q0) {
    mbar_expect_tx(full(s), TILE);
#pragma unroll
    for (int hf = 0; hf < HD / 64; ++hf)
      tma_load(sQ(s) + hf * HALF, pq, full(s), 64 * hf, h, q0, b);
  };

  if (tid == 0) {
    mbar_init(bar_k, 1);
#pragma unroll
    for (int s = 0; s < QSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_k, TILE);
#pragma unroll
    for (int hf = 0; hf < HD / 64; ++hf)
      tma_load(sK + hf * HALF, &tk, bar_k, 64 * hf, kvh, k0, b);
    for (int s = 0; s < QSTAGES && s < n_qt; ++s) load_q(s, first + s * BM);
  }

  const float* ms = m_in + ((size_t)b * H + h) * C;
  const float* ls = l_in + ((size_t)b * H + h) * C;
  // col[2j + i]: key 8j + 2t + i of the tile, over this lane's rows
  float col[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) col[i] = 0.f;
  mbar_wait(bar_k, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_qt; ++it) {
    const int q0 = first + it * BM;
    mbar_wait(full(s), phase);
    // does any counted row fall in this warpgroup's 64 (uniform per
    // warpgroup, as wgmma needs)?
    const int w0 = q0 + 64 * wg;
    if (w0 < r_end && w0 + 64 > r_begin) {
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      const uint64_t dq = desc_sw128(sQ(s) + wg * 64 * 128, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {  // attention_sm90's k-steps
        const uint32_t off = (kk >> 2) * HALF + (kk & 3) * 32;
        wgmma_ss_n128(sc, dq + (off >> 4), desc_sw128(sK + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int r_lo = w0 + 16 * warp + g, r_hi = r_lo + 8;
      const bool v_lo = r_lo >= r_begin && r_lo < r_end;
      const bool v_hi = r_hi >= r_begin && r_hi < r_end;
      // the attention tile's m * scale_log2 and 1 / max(l, L_FLOOR)
      const float ms_lo = v_lo ? ms[r_lo] * scale_log2 : 0.f;
      const float ms_hi = v_hi ? ms[r_hi] * scale_log2 : 0.f;
      const float il_lo = v_lo ? 1.f / fmaxf(ls[r_lo], L_FLOOR) : 0.f;
      const float il_hi = v_hi ? 1.f / fmaxf(ls[r_hi], L_FLOOR) : 0.f;
      const int qp_lo = q_offset + r_lo, qp_hi = q_offset + r_hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const bool lo = e < 2;
          const int qp = lo ? qp_lo : qp_hi;
          const bool ok = (lo ? v_lo : v_hi) && kp < K && kp <= qp &&
                          (window <= 0 || qp - kp < window);
          const float p =
              ex2(fmaf(sc[4 * j + e], scale_log2, lo ? -ms_lo : -ms_hi)) *
              (lo ? il_lo : il_hi);
          col[2 * j + (e & 1)] += ok ? p : 0.f;
        }
      }
    }
    mbar_arrive(empty(s));  // this thread is done with stage s
    if (tid == 0 && it + QSTAGES < n_qt) {
      mbar_wait(empty(s), phase);  // all 256 are: refill it
      load_q(s, q0 + QSTAGES * BM);
    }
    __syncwarp();
    if (++s == QSTAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  // over the 8 row lanes g of each warp, then the 8 warps in order
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      col[i] += __shfl_xor_sync(0xffffffffu, col[i], o);
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      red[tid >> 5][8 * j + 2 * t] = col[2 * j];
      red[tid >> 5][8 * j + 2 * t + 1] = col[2 * j + 1];
    }
  }
  __syncthreads();
  if (tid < BN && k0 + tid < K) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS / 32; ++w) tot += red[w][tid];
    mb[k0 + tid] = tot;
  }
}

// Kernel 2's column masses from the (B, H, C) m_in, l_in that
// launch<..., STATS = true> stored: masses (B, H, K) float32 over the rows
// with q_offset + row < n_total.
template <int HD>
cudaError_t launch_column_masses(const void* q, const void* k,
                                 const float* m_in, const float* l_in,
                                 float* masses, int B, int C, int H, int K,
                                 int KV, int q_offset, int n_total,
                                 int window, cudaStream_t stream) {
  CUtensorMap tq, tk;
  cudaError_t err = tensor_map(&tq, q, HD, H, C, B, BM);
  if (err == cudaSuccess) err = tensor_map(&tk, k, HD, KV, K, B, BN);
  if (err != cudaSuccess) return err;
  // the alignment pad, K, QSTAGES x Q: 193 KB at hd 256
  const int smem = 1024 + (1 + QSTAGES) * (HD / 64) * HALF;
  auto* kern = column_masses_sm90<HD>;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((K + BN - 1) / BN, H, B);
  kern<<<grid, CONSUMERS, smem, stream>>>(tq, tk, m_in, l_in, masses, C, H,
                                          K, KV, q_offset, n_total, window,
                                          log2e_scale(HD));
  return cudaGetLastError();
}

}  // namespace sm90
