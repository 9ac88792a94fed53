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
// balance point, so the floor is bytes / 3.35 TB/s. The decode launches it
// at 16 to 4096 rows, at most one wave of warps, so each launch's time is
// one row's chain: load, reduce, normalise, store. Design: one warp per row
// of C, the row held in registers between the statistics and the affine
// pass (NCH 16-byte chunks per lane, a template argument: exact for the
// published widths C = 64 * depth, rounded up to a power of two for other
// C, the chunks past the row masked), so x is read from memory once. Every
// load of the row and of its (scale + 1) and shift (as 16-byte loads, already
// rounded to the input dtype and packed like x) is issued before the
// shuffle reduction, so their latencies overlap. A lane's modulation is 8
// bytes an element against x's 2 (bf16), so only rows of at most 32
// elements a lane (C <= 1024) take scale and shift early; wider rows load
// them after the reduction, to keep the registers and the occupancy.

#include "common.cuh"

using namespace vtt;

namespace {

constexpr int kWarps = 4;  // rows per block

// VEC floats of a (B, C) modulation row from element c0, as 16-byte loads
// where the row allows them (the wrapper's strides), else one by one.
template <int VEC>
__device__ __forceinline__ void load_mod(const float* __restrict__ p, int c0, bool vec,
                                         float (&v)[VEC]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + c0 + i);
      v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[c0 + i];
  }
}

// (scale + 1) and shift for chunk c (VEC elements), rounded to T as the
// affine step takes them, packed like a chunk of x.
template <typename T>
__device__ __forceinline__ void mod_chunk(const float* __restrict__ sc,
                                          const float* __restrict__ sh, int c, bool vec,
                                          uint4& scp, uint4& shp) {
  constexpr int VEC = 16 / sizeof(T);
  float a[VEC], b[VEC];
  load_mod<VEC>(sc, c * VEC, vec, a);
  load_mod<VEC>(sh, c * VEC, vec, b);
  T* ps = reinterpret_cast<T*>(&scp);
  T* ph = reinterpret_cast<T*>(&shp);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    ps[i] = from_f<T>(rnd<T>(a[i]) + 1.0f);
    ph[i] = from_f<T>(b[i]);
  }
}

template <typename T, int NCH>
__global__ void __launch_bounds__(32 * kWarps)
modulated_ln_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, T* __restrict__ out, long long rows, int L,
                    int C, long long scale_stride, long long shift_stride, float eps,
                    bool vec_mod) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk (the wrapper checks C)
  constexpr bool kPrefetch = NCH * VEC <= 32;  // scale and shift before the reduction
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nch = C / VEC;  // chunks in the row; lane's chunk j is j * 32 + lane
  const long long b = row / L;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
  uint4* yr = reinterpret_cast<uint4*>(out + row * C);
  const float* sc = scale + b * scale_stride;
  const float* sh = shift + b * shift_stride;

  uint4 xv[NCH], scp[kPrefetch ? NCH : 1], shp[kPrefetch ? NCH : 1];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = j * 32 + lane;
    xv[j] = c < nch ? xr[c] : make_uint4(0, 0, 0, 0);  // zeros add nothing to the sums
  }
  if constexpr (kPrefetch) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = j * 32 + lane;
      if (c < nch) mod_chunk<T>(sc, sh, c, vec_mod, scp[j], shp[j]);
    }
  }

  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const T* e = reinterpret_cast<const T*>(&xv[j]);
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

#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = j * 32 + lane;
    if (c >= nch) break;
    uint4 scj, shj;
    if constexpr (kPrefetch) {
      scj = scp[j], shj = shp[j];
    } else {
      mod_chunk<T>(sc, sh, c, vec_mod, scj, shj);
    }
    const T* e = reinterpret_cast<const T*>(&xv[j]);
    const T* es = reinterpret_cast<const T*>(&scj);
    const T* eh = reinterpret_cast<const T*>(&shj);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float y = rnd<T>(rnd<T>(to_f(e[i]) - mu_t) * inv_t);
      y = rnd<T>(y * to_f(es[i]));
      o[i] = from_f<T>(y + to_f(eh[i]));
    }
    yr[c] = packed;
  }
}

// Chunks per lane that have their own instantiation: exact for the
// published widths (bf16 C = 1024, 1280, 1536, 1920, 2304: 4, 5, 6, 8, 9;
// fp32: 8, 10, 12, 15, 18), powers of two for the rest. 32 is the most.
template <typename T>
cudaError_t launch(const T* x, const float* scale, const float* shift, T* out, long long rows,
                   int L, int C, long long scale_stride, long long shift_stride, float eps,
                   bool vec_mod, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_lane = (C / VEC + 31) / 32;
  const dim3 block(32 * kWarps), grid((unsigned)((rows + kWarps - 1) / kWarps));
#define VTT_LN_CASE(n)                                                                        \
  if (per_lane <= n) {                                                                        \
    modulated_ln_kernel<T, n><<<grid, block, 0, st>>>(x, scale, shift, out, rows, L, C,       \
                                                      scale_stride, shift_stride, eps,        \
                                                      vec_mod);                               \
    return cudaGetLastError();                                                                \
  }
  VTT_LN_CASE(1) VTT_LN_CASE(2) VTT_LN_CASE(4) VTT_LN_CASE(5) VTT_LN_CASE(6) VTT_LN_CASE(8)
  VTT_LN_CASE(9) VTT_LN_CASE(10) VTT_LN_CASE(12) VTT_LN_CASE(15) VTT_LN_CASE(16)
  VTT_LN_CASE(18) VTT_LN_CASE(32)
#undef VTT_LN_CASE
  return cudaErrorInvalidValue;  // rows of more than 32 * 32 chunks: ops/cuda/fused_ln.py
}

}  // namespace

extern "C" int var_modulated_layernorm(const void* x, const void* scale, const void* shift,
                                       void* out, long long rows, int L, int C,
                                       long long scale_stride, long long shift_stride,
                                       float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* sh = (const float*)shift;
  // 16-byte modulation loads: both rows start on 16-byte boundaries
  const bool vec_mod = ((uintptr_t)sc & 15) == 0 && ((uintptr_t)sh & 15) == 0 &&
                       scale_stride % 4 == 0 && shift_stride % 4 == 0;
  if (dtype == kF32) {
    err = launch<float>((const float*)x, sc, sh, (float*)out, rows, L, C, scale_stride,
                        shift_stride, eps, vec_mod, st);
  } else if (dtype == kBF16) {
    err = launch<__nv_bfloat16>((const __nv_bfloat16*)x, sc, sh, (__nv_bfloat16*)out, rows, L,
                                C, scale_stride, shift_stride, eps, vec_mod, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* var_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
