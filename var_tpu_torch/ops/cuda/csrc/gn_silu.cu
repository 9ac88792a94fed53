// GroupNorm, then SiLU or nothing, over channels-last (NHWC) bfloat16 or
// float16 activations: every GroupNorm of the VQVAE decoder in inference;
// and over float32 ones: every GroupNorm of the frozen encoder in float32
// inference (models/vae.py::channels_last_encode), whose convolutions are
// conv3xtf32.cu's.
//
//   y[b, p, c] = silu((x[b, p, c] + bias_in[c]) * scale[b, c] + shift[b, c])   (p: pixel)
//   scale[b, c] = weight[c] * rstd[b, g(c)]
//   shift[b, c] = bias[c] - mean[b, g(c)] * scale[b, c]
//
// with mean and rstd of x + bias_in over the H * W * C / G elements of each
// (batch, group), in float32, and one rounding to the input type at the end.
// bias_in (may be null) is the bias of the convolution that made x, which
// the decoder leaves out of it: PyTorch would add it in a broadcasting pass
// of its own. Replaces no TPU
// kernel: the JAX package leaves GroupNorm and SiLU to XLA, which fuses them
// and keeps the layout. PyTorch's GroupNorm on CUDA copies channels-last input
// to dense NCHW, so the decoder's convolutions after it got NCHW and cuDNN
// transposed to NHWC and back around each of them, and the apply and the SiLU
// were separate broadcasting passes. With this kernel the decoder stays NHWC
// from its first convolution to its last (models/vae.py).
//
// Bound on the H100: memory. The statistics read x once (2 bytes an element),
// the apply reads it again and writes y (4 bytes), against ~10 flops an
// element: the floor is 6 bytes an element over 3.35 TB/s (12 in float32).
//
// Design. A pixel's C channels are contiguous, so a thread owns one vector
// of 8 channels (16 bytes; 32 in float32, two 16-byte loads) at a fixed
// column of the pixel and a block of rows x C/8 threads walks a tile of the
// image's pixels rows at a time, four vectors in flight a thread. Groups of
// the decoder and the encoder are 5, 10 and 20 channels (C 160, 320, 640 over
// 32 groups), so a vector straddles groups and the reduction is per channel
// first.
//
// Statistics kernel (grid: tiles x batch). Each thread keeps a Welford mean
// and M2 for its 8 channels over its pixels, a block merges its rows per
// channel and then the channels of each group by Chan's formula, in a fixed
// order, and writes (count, mean, M2) for each (batch, tile, group) to the
// scratch the wrapper allocated. A level-0 group is 327,680 elements whose
// mean can be large beside their spread; E[x^2] - mean^2 would cancel there.
//
// Finalize kernel (grid: batch). One warp a group merges the tiles' partials
// (lanes over the tiles, a shuffle tree) and folds weight, bias, mean and
// rstd (and bias_in) into one float32 scale and shift for each channel of the
// group, written to the scratch as a float2 per (batch, channel). Done once
// here, so that an apply block reads C float2s and not every tile's partials
// of its batch again (81 tiles x 32 groups x 16 bytes at level 0).
//
// Apply kernel (the statistics' grid). Each thread loads the scale and shift
// of its 8 channels and writes y with 16-byte stores. SiLU is a template
// flag: the attention blocks' norms take the kernel without it.
//
// Tiles are sized by the wrapper (ops/cuda/gn_silu.py) so that a launch has
// several blocks on every SM at batch 8 as at batch 50. Nothing is allocated
// here, nothing is atomic: reruns give the same bits, and the three kernels
// capture into a CUDA graph.

#include "common.cuh"

using namespace vtt;

namespace {

constexpr int kVec = 8;  // channels in one vector
constexpr int kUnroll = 4;  // vectors in flight a thread

// kVec channels as 16-byte words: one of a 2-byte type, two of float
template <typename T> struct Vec {
  uint4 w[kVec * sizeof(T) / 16];
};

// Fold the partial (nb, mb, m2b) into (n, mean, m2) (Chan et al.).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  const float f = nb / nn;
  mean = fmaf(d, f, mean);
  m2 = m2 + m2b + d * d * n * f;
  n = nn;
}

template <typename T>
__global__ void __launch_bounds__(256)
gn_silu_stats_kernel(const T* __restrict__ x, const float* __restrict__ bias_in,
                     float4* __restrict__ part, int hw, int c, int groups, int tile) {
  extern __shared__ float smem[];
  const int nv = c / kVec, rows = blockDim.x / nv;
  const int cv = threadIdx.x % nv, r = threadIdx.x / nv;
  const int b = blockIdx.y, t = blockIdx.x, tiles = gridDim.x;
  const int p0 = t * tile, p1 = min(p0 + tile, hw);
  const Vec<T>* xb = reinterpret_cast<const Vec<T>*>(x) + (long long)b * hw * nv + cv;

  float mean[kVec], m2[kVec], add[kVec], n = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    mean[k] = m2[k] = 0.f;
    add[k] = bias_in ? bias_in[cv * kVec + k] : 0.f;
  }
  for (int p = p0 + r; p < p1; p += rows * kUnroll) {
    Vec<T> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      raw[u] = q < p1 ? xb[(long long)q * nv] : Vec<T>{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * rows >= p1) break;
      n += 1.f;
      const float rn = 1.f / n;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float v = to_f(e[k]) + add[k];
        const float d = v - mean[k];
        mean[k] = fmaf(d, rn, mean[k]);
        m2[k] = fmaf(d, v - mean[k], m2[k]);
      }
    }
  }

  // rows x C means and M2s, then each row's count
  float* s_mean = smem;
  float* s_m2 = smem + rows * c;
  float* s_n = smem + 2 * rows * c;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    s_mean[r * c + cv * kVec + k] = mean[k];
    s_m2[r * c + cv * kVec + k] = m2[k];
  }
  if (cv == 0) s_n[r] = n;
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {  // the rows, in order
    float cn = s_n[0], cm = s_mean[ch], cm2 = s_m2[ch];
    for (int i = 1; i < rows; ++i)
      chan_merge(cn, cm, cm2, s_n[i], s_mean[i * c + ch], s_m2[i * c + ch]);
    s_mean[ch] = cm;
    s_m2[ch] = cm2;
  }
  __syncthreads();
  const int cpg = c / groups;
  const float tn = (float)max(p1 - p0, 0);  // every channel saw the tile's pixels
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {  // the group's channels, in order
    float gn = tn, gm = s_mean[g * cpg], gm2 = s_m2[g * cpg];
    for (int j = 1; j < cpg; ++j)
      chan_merge(gn, gm, gm2, tn, s_mean[g * cpg + j], s_m2[g * cpg + j]);
    part[((long long)b * tiles + t) * groups + g] = make_float4(gn, gm, gm2, 0.f);
  }
}

__global__ void __launch_bounds__(1024)
gn_silu_finalize_kernel(const float4* __restrict__ part, const float* __restrict__ weight,
                        const float* __restrict__ bias, const float* __restrict__ bias_in,
                        float2* __restrict__ ss, int tiles, int c, int groups, float eps) {
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, cpg = c / groups;
  const float4* pb = part + (long long)b * tiles * groups;
  for (int g = warp; g < groups; g += warps) {  // g: one value a warp
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int i = lane; i < tiles; i += 32) {  // the tiles, in order
      const float4 q = pb[(long long)i * groups + g];
      chan_merge(n, m, m2, q.x, q.y, q.z);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // lane 0 ends with every lane's partial
      const float nb = __shfl_down_sync(0xffffffffu, n, o);
      const float mb = __shfl_down_sync(0xffffffffu, m, o);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, o);
      if (lane < o) chan_merge(n, m, m2, nb, mb, m2b);
    }
    const float mean = __shfl_sync(0xffffffffu, m, 0);
    const float rstd = rsqrtf(fmaxf(__shfl_sync(0xffffffffu, m2, 0)
                                    / __shfl_sync(0xffffffffu, n, 0), 0.f) + eps);
    for (int ch = g * cpg + lane; ch < (g + 1) * cpg; ch += 32) {
      const float sc = weight[ch] * rstd;
      float sh = fmaf(-mean, sc, bias[ch]);
      if (bias_in) sh = fmaf(bias_in[ch], sc, sh);  // (x + bias_in) * sc + sh
      ss[(long long)b * c + ch] = make_float2(sc, sh);
    }
  }
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(256)
gn_silu_apply_kernel(const T* __restrict__ x, const float2* __restrict__ ss,
                     T* __restrict__ y, int hw, int c, int tile) {
  const int b = blockIdx.y, t = blockIdx.x;
  const int nv = c / kVec, rows = blockDim.x / nv;
  const int cv = threadIdx.x % nv, r = threadIdx.x / nv;
  float sc[kVec], sh[kVec];
  const float4* sb = reinterpret_cast<const float4*>(ss + (long long)b * c + cv * kVec);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {  // two channels' (scale, shift) a load
    const float4 q = sb[k];
    sc[2 * k] = q.x;
    sh[2 * k] = q.y;
    sc[2 * k + 1] = q.z;
    sh[2 * k + 1] = q.w;
  }
  const int p0 = t * tile, p1 = min(p0 + tile, hw);
  const long long base = (long long)b * hw * nv + cv;
  const Vec<T>* xb = reinterpret_cast<const Vec<T>*>(x) + base;
  Vec<T>* yb = reinterpret_cast<Vec<T>*>(y) + base;
  for (int p = p0 + r; p < p1; p += rows * kUnroll) {
    Vec<T> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      raw[u] = q < p1 ? xb[(long long)q * nv] : Vec<T>{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * rows;
      if (q >= p1) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      Vec<T> out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        float v = fmaf(to_f(e[k]), sc[k], sh[k]);
        if constexpr (kSilu) v = __fdividef(v, 1.f + __expf(-v));
        o[k] = from_f<T>(v);
      }
      yb[(long long)q * nv] = out;
    }
  }
}

template <typename T>
int launch(const void* x, const void* weight, const void* bias, const void* bias_in, void* part,
           void* ss, void* y, int b, int hw, int c, int groups, int tile, int tiles, float eps,
           bool silu, cudaStream_t st) {
  const int nv = c / kVec, rows = max(1, 256 / nv);
  const dim3 grid((unsigned)tiles, (unsigned)b), block((unsigned)(rows * nv));
  gn_silu_stats_kernel<T><<<grid, block, (2 * rows * c + rows) * sizeof(float), st>>>(
      (const T*)x, (const float*)bias_in, (float4*)part, hw, c, groups, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_silu_finalize_kernel<<<(unsigned)b, (unsigned)min(32 * groups, 1024), 0, st>>>(
      (const float4*)part, (const float*)weight, (const float*)bias, (const float*)bias_in,
      (float2*)ss, tiles, c, groups, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (silu) {
    gn_silu_apply_kernel<T, true><<<grid, block, 0, st>>>((const T*)x, (const float2*)ss, (T*)y,
                                                          hw, c, tile);
  } else {
    gn_silu_apply_kernel<T, false><<<grid, block, 0, st>>>((const T*)x, (const float2*)ss, (T*)y,
                                                           hw, c, tile);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int var_gn_silu(const void* x, const void* weight, const void* bias,
                           const void* bias_in, void* part, void* ss, void* y, int b, int hw,
                           int c, int groups, int tile, int tiles, float eps, int silu,
                           int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (c % kVec || c % groups || c / kVec > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    return launch<float>(x, weight, bias, bias_in, part, ss, y, b, hw, c, groups, tile, tiles,
                         eps, silu != 0, st);
  }
  if (dtype == kBF16) {
    return launch<__nv_bfloat16>(x, weight, bias, bias_in, part, ss, y, b, hw, c, groups, tile,
                                 tiles, eps, silu != 0, st);
  }
  if (dtype == kF16) {
    return launch<__half>(x, weight, bias, bias_in, part, ss, y, b, hw, c, groups, tile, tiles,
                          eps, silu != 0, st);
  }
  return (int)cudaErrorInvalidValue;
}
