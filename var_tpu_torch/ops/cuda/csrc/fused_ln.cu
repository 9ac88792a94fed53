// Row 1 of the kernel table (PERF.md): fused modulated LayerNorm of the
// VAR decode path.
//
//   out[b, l, :] = LN(x[b, l, :]) * (scale[b, :] + 1) + shift[b, :]
//
// Replaces var_tpu/ops/pallas/fused_ln.py::modulated_layernorm (_kernel :38),
// the AdaLN pre-norm that every transformer block runs twice per scale.
// Dtype staging mirrors the JAX function bit for bit in structure: fp32
// statistics in E[x^2] - mu^2 form, then normalise and modulate in the input
// dtype (each bf16 op rounds to bf16, as XLA's elementwise ops do).
//
// Bound on the H100: memory. Each element is read once and written once
// (bf16: 4 bytes) against ~10 flops, far below the card's ~295 flop/byte
// balance point, so the floor is bytes / 3.35 TB/s. Design: one warp per
// row of C, statistics reduced with warp shuffles (no shared memory, no
// block barrier), 16-byte vector loads and stores (512 bytes per warp
// instruction), the row re-read for the affine pass from L1 (a C = 1024
// bf16 row is 2 KB).

#include "common.cuh"

using namespace vtt;

template <typename T>
__global__ void modulated_ln_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                    const float* __restrict__ shift, T* __restrict__ out,
                                    long long rows, int L, int C, long long scale_stride,
                                    long long shift_stride, float eps) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load (the wrapper checks C)
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long b = row / L;
  const T* xr = x + row * C;
  T* yr = out + row * C;

  float s = 0.f, ss = 0.f;
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = to_f(e[i]);
      s += v;
      ss += v * v;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)C;
  const float var = ss / (float)C - mu * mu;
  const float inv = rsqrtf(var + eps);
  const float mu_t = rnd<T>(mu), inv_t = rnd<T>(inv);

  const float* sc = scale + b * scale_stride;
  const float* sh = shift + b * shift_stride;
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);  // second read hits L1
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float y = rnd<T>(rnd<T>(to_f(e[i]) - mu_t) * inv_t);
      y = rnd<T>(y * rnd<T>(rnd<T>(sc[c + i]) + 1.0f));
      o[i] = from_f<T>(y + rnd<T>(sh[c + i]));
    }
    *reinterpret_cast<uint4*>(yr + c) = packed;
  }
}

extern "C" int var_modulated_layernorm(const void* x, const void* scale, const void* shift,
                                       void* out, long long rows, int L, int C,
                                       long long scale_stride, long long shift_stride,
                                       float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int warps = 4;
  const dim3 block(32 * warps);
  const dim3 grid((unsigned)((rows + warps - 1) / warps));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    modulated_ln_kernel<float><<<grid, block, 0, st>>>(
        (const float*)x, (const float*)scale, (const float*)shift, (float*)out, rows, L, C,
        scale_stride, shift_stride, eps);
  } else if (dtype == kBF16) {
    modulated_ln_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)shift,
        (__nv_bfloat16*)out, rows, L, C, scale_stride, shift_stride, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* var_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
