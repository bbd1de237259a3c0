// Shared helpers of the port's CUDA kernels (built for sm_90a with nvcc,
// bound through a plain C interface and loaded with ctypes).
//
// Every kernel follows the masking rules of the Pallas kernels it
// replaces: masked logits are NEG_INF, masked probabilities are exact
// zeros (where(ok, exp(s - m), 0)), the row normaliser is clamped at
// 1e-30 so a row with nothing to attend gives exact zeros, the scale is
// 1/sqrt(hd), and every sum is taken in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define L_FLOOR 1e-30f

// dtype codes passed from Python (kernels/build.py: DTYPE_CODES)
#define DTYPE_F32 0
#define DTYPE_BF16 1

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Kernel 2's column masses: the rows of a chunk whose softmax mass on the
// key tile [k0, k0 + tile) counts, [*r_begin, *r_end).  A row counts while
// q_offset + row < n_total; it sees the tile from row k0 - q_offset on
// (causal) and, with a window, only up to row k0 + tile - 2 + window -
// q_offset.
__device__ __forceinline__ void counted_rows(int k0, int tile, int C,
                                             int q_offset, int n_total,
                                             int window, int* r_begin,
                                             int* r_end) {
  *r_begin = max(0, k0 - q_offset);
  int end = min(C, n_total - q_offset);
  if (window > 0) end = min(end, k0 + tile - 1 + window - q_offset);
  *r_end = end;
}

// cp.async, ldmatrix and mma.sync (sm_80 and up), for the kernels that
// stage tiles by hand rather than through the Hopper tile's TMA ring.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, bypassing registers and L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// The same; with `valid` false it writes zeros and reads nothing (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i .. 8i + 7 give matrix i's row addresses.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 bf16 matrices, transposed on the way into registers: lane (g, t)
// receives M[2t][g], M[2t+1][g] of each — the B fragment of P.V straight
// from row-major V.  Lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(row)));
}

// d += a . b, m16n8k16, bf16 operands, float32 accumulators.  Fragments
// (g = lane / 4, t = lane % 4): A (row g, k 2t..2t+1), (row g+8, k 2t..),
// (row g, k 8+2t..), (row g+8, k 8+2t..); B (k 2t..2t+1, col g), (k 8+2t..,
// col g); D (row g, col 2t), (row g, col 2t+1), (row g+8, col 2t),
// (row g+8, col 2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on the way into registers: lanes
// 8i .. 8i + 7 give matrix i's row addresses, lane (g, t) receives
// M_i[2t][g], M_i[2t+1][g] of each.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Programmatic dependent launch: the launch after this one on the stream
// (made with the programmatic-serialization attribute) may start once
// every CTA of this grid has run this ...
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// ... and waits here until this grid's predecessor has finished and its
// stores are visible (at once when it was launched without the attribute).
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Raise the dynamic shared-memory ceiling of a kernel instantiation above
// the 48 KB default (once per process and instantiation).
template <typename F>
static cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
