// One decode stage's K and V into the KV cache: the per-head L2 norm of K
// and both cache writes in one pass (models/var.py::attn_apply).
//
//   k_dst[b, t, h*D:(h+1)*D] = k[b, t, h*D:(h+1)*D] * rsqrt(sum_d k[b, t, h*D + d]^2 + 1e-24)
//   v_dst[b, t, :]           = v[b, t, :]
//
// with the sum of squares and the product in float32 and one rounding to the
// cache's type; without the norm (``attn_l2_norm`` off) K is copied as it is.
// k and v are the K and V column blocks of the fused qkv GEMM's (B, l, 3C)
// output, read in place; k_dst and v_dst are the rows [cum, cum + l) of the
// layer's (B, Lmax, C) cache buffers. Nothing else is read or written.
// Replaces no TPU kernel: the JAX package leaves the norm and the cache write
// to XLA, which fuses them. In PyTorch they were seven launches: a strided
// cast to float32, the square, the sum, the epsilon, the rsqrt, a
// broadcasting product into a strided view of the cache, and the strided V
// copy, about 28 bytes of traffic an element of K against the 8 here.
//
// Bound on the H100: memory. K and V are read once and written once (2 bytes
// each an element in bf16), against ~3 flops an element.
//
// Design. A thread owns 16-byte vectors of one (row, head): vector j, j + P,
// j + 2P, ... of the head's D / kVec, where P, the lanes of a head, is a power
// of two (the wrapper takes the largest not above D / kVec, at most 32), so a
// head's lanes are consecutive lanes of one warp and their partial sums meet
// in log2(P) xor shuffles within the group: 8 lanes for bf16 at D 64, 16 for
// float32. Consecutive heads of a row, and consecutive rows, lie in
// consecutive groups, so a warp reads 32 contiguous 16-byte vectors of K and
// of V. Any head count (an odd count under a model axis), any row and batch
// stride that keeps 16-byte vectors aligned. Lanes past the last (row, head)
// take part in the shuffles and store nothing.

#include "common.cuh"

using namespace vtt;

namespace {

constexpr int kMaxPer = 4;  // most vectors of one head a lane holds

template <typename T, bool kNorm>
__global__ void __launch_bounds__(256)
kv_write_kernel(const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ k_dst,
                T* __restrict__ v_dst, long long pairs, int l, int heads, int nvec, int lg_lanes,
                int per, long long src_b, long long src_r, long long dst_b, long long dst_r) {
  constexpr int kVec = 16 / sizeof(T);
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long pair = gt >> lg_lanes;
  const int lanes = 1 << lg_lanes, sub = (int)(gt & (lanes - 1));
  const bool live = pair < pairs;
  long long src = 0, dst = 0;
  if (live) {
    const long long row = pair / heads;
    const int h = (int)(pair - row * heads);
    const long long b = row / l, t = row - b * l;
    const long long col = (long long)h * nvec * kVec;
    src = b * src_b + t * src_r + col;
    dst = b * dst_b + t * dst_r + col;
  }
  uint4 kr[kMaxPer], vr[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int j = sub + i * lanes;
    if (live && i < per && j < nvec) {
      kr[i] = *reinterpret_cast<const uint4*>(k + src + (long long)j * kVec);
      vr[i] = *reinterpret_cast<const uint4*>(v + src + (long long)j * kVec);
    } else {
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float inv = 1.f;
  if constexpr (kNorm) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const T* e = reinterpret_cast<const T*>(&kr[i]);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float x = to_f(e[q]);
        ss = __fadd_rn(ss, __fmul_rn(x, x));  // each square rounded, as PyTorch's
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    inv = rsqrtf(ss + 1e-24f);
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int j = sub + i * lanes;
    if (i >= per || j >= nvec) break;
    uint4 out = kr[i];
    if constexpr (kNorm) {
      const T* e = reinterpret_cast<const T*>(&kr[i]);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int q = 0; q < kVec; ++q) o[q] = from_f<T>(to_f(e[q]) * inv);
    }
    *reinterpret_cast<uint4*>(k_dst + dst + (long long)j * kVec) = out;
    *reinterpret_cast<uint4*>(v_dst + dst + (long long)j * kVec) = vr[i];
  }
}

template <typename T>
int launch(const void* k, const void* v, void* k_dst, void* v_dst, long long rows, int l,
           int heads, int d, int lg_lanes, bool norm, long long src_b, long long src_r,
           long long dst_b, long long dst_r, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec, lanes = 1 << lg_lanes;
  const int per = (nvec + lanes - 1) / lanes;
  if (d % kVec || lanes > 32 || lanes > nvec || per > kMaxPer) {
    return (int)cudaErrorInvalidValue;
  }
  const long long pairs = rows * heads;
  const long long blocks = (pairs * lanes + 255) / 256;
  if (blocks == 0) return (int)cudaSuccess;
  if (norm) {
    kv_write_kernel<T, true><<<(unsigned)blocks, 256, 0, st>>>(
        (const T*)k, (const T*)v, (T*)k_dst, (T*)v_dst, pairs, l, heads, nvec, lg_lanes, per,
        src_b, src_r, dst_b, dst_r);
  } else {
    kv_write_kernel<T, false><<<(unsigned)blocks, 256, 0, st>>>(
        (const T*)k, (const T*)v, (T*)k_dst, (T*)v_dst, pairs, l, heads, nvec, lg_lanes, per,
        src_b, src_r, dst_b, dst_r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows = B * l; strides in elements: src_b, src_r of k and v, dst_b, dst_r of
// k_dst and v_dst.
extern "C" int var_kv_write(const void* k, const void* v, void* k_dst, void* v_dst,
                            long long rows, int l, int heads, int d, int lg_lanes, int norm,
                            long long src_b, long long src_r, long long dst_b, long long dst_r,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kBF16) {
    return launch<__nv_bfloat16>(k, v, k_dst, v_dst, rows, l, heads, d, lg_lanes, norm != 0,
                                 src_b, src_r, dst_b, dst_r, st);
  }
  if (dtype == kF16) {
    return launch<__half>(k, v, k_dst, v_dst, rows, l, heads, d, lg_lanes, norm != 0, src_b,
                          src_r, dst_b, dst_r, st);
  }
  if (dtype == kF32) {
    return launch<float>(k, v, k_dst, v_dst, rows, l, heads, d, lg_lanes, norm != 0, src_b,
                         src_r, dst_b, dst_r, st);
  }
  return (int)cudaErrorInvalidValue;
}
