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

}  // namespace vtt

// Error string for a code returned by one of the launch functions.
extern "C" const char* var_cuda_error_string(int code);
