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

// Raise the dynamic shared-memory ceiling of a kernel instantiation above
// the 48 KB default (once per process and instantiation).
template <typename F>
static cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
