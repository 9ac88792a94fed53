// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vtt {

// dtype codes passed from Python (see ops/cuda/build.py::dtype_code)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype/.to() do
}

// Round a float through T: the value one elementwise op computed in T gives.
// Identity for float.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max with the result broadcast to every thread. ``red``
// holds at least 33 slots of shared memory. Two barriers: the second makes
// the broadcast slot safe to rewrite in the next call, since no thread can
// reach that call's first barrier before reading this call's result.
template <typename U>
__device__ __forceinline__ U block_sum(U v, U* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    U t = lane < (int)(blockDim.x >> 5) ? red[lane] : U(0);
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// Tensor-core building blocks (mma.sync m16n8k16, bf16 in, fp32 accumulate).
// Fragment layout, with g = lane / 4 and t = lane % 4: the A operand (16 x 16,
// row-major) holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// the B operand (16 x 8) holds, for column n = g, rows 2t, 2t + 1 and
// 2t + 8, 2t + 9, so B is read from shared memory stored [n][k]; the
// accumulator (16 x 8) holds rows g and g + 8, columns 2t, 2t + 1 -- which is
// the A layout of two neighbouring accumulator tiles, so a product's fp32
// result feeds the next product as A after rounding to bf16.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace vtt

// Error string for a code returned by one of the launch functions.
extern "C" const char* var_cuda_error_string(int code);
