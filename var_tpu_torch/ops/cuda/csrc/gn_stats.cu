// Row 7 of the kernel table (PERF.md): GroupNorm channel statistics of the
// VQVAE.
//
//   s[b, c] = sum_{h, w} x[b, c, h, w]     ss[b, c] = sum_{h, w} x[b, c, h, w]^2
//
// in float32 for float32 and bfloat16 inputs. Replaces
// var_tpu/ops/pallas/gn_stats.py::gn_channel_stats (_kernel :28, pallas_call
// :83). The TPU kernel walks an NHWC tile down its rows and accumulates
// per-channel sums in VMEM across a sequential grid; here the activation is
// dense NCHW, so each (b, c) pair is one contiguous row of H * W elements and
// the function is a row reduction over B * C rows. The group sums and the
// apply step stay in PyTorch (models/vae.py::group_norm), as they stay in XLA
// on the TPU; so does the VJP (ops/cuda/gn_stats.py), which JAX also computes
// outside Pallas.
//
// Bound on the H100: memory. Each element is read once (4 or 2 bytes) against
// 3 flops, far below the card's balance point, so the floor is
// bytes / 3.35 TB/s. Design: WPR warps per row (1 for rows of a few thousand
// elements, up to 8 for the 256 x 256 rows, so enough blocks are in flight
// either way), 16-byte vector loads four at a time where the row starts on a
// 16-byte boundary and a scalar loop for the rest of the row (all of it when
// the row is not aligned), fp32 accumulation, warp shuffles, then a fixed-order
// combine of the row's warps in shared memory. No atomics: a rerun gives the
// same bits.

#include "common.cuh"

using namespace vtt;

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

template <typename T, int WPR>
__global__ void __launch_bounds__(kWarps * 32)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ s_out,
                float* __restrict__ ss_out, long long rows, long long hw) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NT = WPR * 32;  // threads per row
  constexpr int ROWS_PER_BLOCK = kWarps / WPR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / WPR;  // the block's row this warp works on
  const int t = (warp % WPR) * 32 + lane;  // thread index within the row
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + slot;

  float s = 0.f, ss = 0.f;
  if (row < rows) {
    const T* xr = x + row * hw;
    const long long nvec =
        (reinterpret_cast<uintptr_t>(xr) & 15) == 0 ? hw / VEC : 0;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (long long i0 = t; i0 < nvec; i0 += (long long)NT * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + (long long)u * NT;
        raw[u] = i < nvec ? xv[i] : make_uint4(0u, 0u, 0u, 0u);  // zero bits: 0.0 in both types
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = to_f(e[k]);
          s += v;
          ss = fmaf(v, v, ss);
        }
      }
    }
    // scalar tail: what the vector loop left, or the whole row if unaligned
    for (long long i = nvec * VEC + t; i < hw; i += NT) {
      const float v = to_f(xr[i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if constexpr (WPR == 1) {
    if (lane == 0 && row < rows) {
      s_out[row] = s;
      ss_out[row] = ss;
    }
  } else {
    __shared__ float red_s[kWarps], red_ss[kWarps];
    if (lane == 0) {
      red_s[warp] = s;
      red_ss[warp] = ss;
    }
    __syncthreads();
    if (t == 0 && row < rows) {
      float ts = 0.f, tss = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) {  // fixed order: bit-identical reruns
        ts += red_s[slot * WPR + k];
        tss += red_ss[slot * WPR + k];
      }
      s_out[row] = ts;
      ss_out[row] = tss;
    }
  }
}

template <typename T, int WPR>
void launch(const void* x, void* s, void* ss, long long rows, long long hw, cudaStream_t st) {
  constexpr int ROWS_PER_BLOCK = kWarps / WPR;
  const dim3 grid((unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK));
  gn_stats_kernel<T, WPR><<<grid, kWarps * 32, 0, st>>>(
      (const T*)x, (float*)s, (float*)ss, rows, hw);
}

template <typename T>
void launch_rows(const void* x, void* s, void* ss, long long rows, long long hw,
                 cudaStream_t st) {
  // about 8 x kUnroll vectors per thread before a row takes more warps
  const long long per_warp = 32LL * 8 * kUnroll * (16 / sizeof(T));
  if (hw >= 8 * per_warp) {
    launch<T, 8>(x, s, ss, rows, hw, st);
  } else if (hw >= 4 * per_warp) {
    launch<T, 4>(x, s, ss, rows, hw, st);
  } else if (hw >= 2 * per_warp) {
    launch<T, 2>(x, s, ss, rows, hw, st);
  } else {
    launch<T, 1>(x, s, ss, rows, hw, st);
  }
}

}  // namespace

extern "C" int var_gn_channel_stats(const void* x, void* s, void* ss, long long rows,
                                    long long hw, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    launch_rows<float>(x, s, ss, rows, hw, st);
  } else if (dtype == kBF16) {
    launch_rows<__nv_bfloat16>(x, s, ss, rows, hw, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
