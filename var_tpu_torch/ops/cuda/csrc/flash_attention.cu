// Kernel 3: decode attention of one scale's queries over the KV cache.
//
// Replaces var_tpu/ops/pallas/flash_attention.py::flash_decode_paired_chunks
// (_fwd_kernel_paired_chunks :476). Per (sample, head): the queries of the
// current scale attend, unmasked, to cache rows [0, Lk) -- every earlier
// stage plus the current one, which the caller has already written. q is
// read from the first C lanes of the fused (B, Lq, 3C) qkv projection (row
// stride 3C, never copied out). With ``scale_mul`` the per-head q L2 norm
// times the learned scale runs here (k is normalised when the cache is
// written); ``scale`` multiplies the logits after the dot. Logits, softmax
// and the running sums are fp32; with bf16 inputs the normalised q and the
// softmax weights are rounded to bf16 before their products, as the TPU
// kernel feeds bf16 operands to the MXU; fp32 inputs stay fp32 throughout.
// The paired-head 128-lane packing, scalar-prefetched layer index and VMEM
// budget of the TPU kernel are Mosaic workarounds and have no counterpart:
// the caller passes the layer's cache base pointer and strides.
//
// Bound on the H100: memory. At the last 256px stage (Lq = 256, Lk = 680,
// d16, 2B = 16) the kernel must read K and V once (~45 MB bf16) plus q and
// the output (~17 MB), against ~11 GFLOP that the tensor cores do in
// ~12 us. Design: K/V stream through shared memory in 64-key tiles with an
// online softmax, so no (Lq, Lk) matrix exists anywhere.
//   * bf16 (the sampling path): one block per (sample, head, 64-query
//     tile), four warps of 16 queries, both products on the tensor cores
//     with mma.sync (decode_attention_mma_kernel); K/V are read from L2
//     once per 64-query tile.
//   * fp32 (the parity path): the same algorithm on the CUDA cores in full
//     fp32, 16-query tiles (decode_attention_kernel); tensor-core TF32
//     would round the logits.
// Loads are synchronous; cp.async/TMA double buffering and wgmma are left
// for a later tuning pass.

#include "common.cuh"

using namespace vtt;

#define ATT_D 64
#define ATT_BQ 16
#define ATT_BK 64
#define ATT_WARPS 4
#define ATT_QPW (ATT_BQ / ATT_WARPS)

// fp32: CUDA cores, 16-query tiles, four warps of four queries; K/V tiles
// in shared memory, keys (k0 + lane) and (k0 + lane + 32) per lane.
__global__ void __launch_bounds__(ATT_WARPS * 32)
decode_attention_kernel(const float* __restrict__ q, long long q_bs, long long q_rs,
                        const float* __restrict__ k, const float* __restrict__ v, long long kv_bs,
                        long long kv_rs, float* __restrict__ out, long long o_bs, long long o_rs,
                        const float* __restrict__ scale_mul, int Lq, int Lk, float scale) {
  __shared__ float qs[ATT_BQ][ATT_D];
  __shared__ float ks[ATT_BK][ATT_D + 1];  // +1: lane-indexed rows hit distinct banks
  __shared__ float vs[ATT_BK][ATT_D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * ATT_BQ;

  const float* qb = q + b * q_bs + (long long)h * ATT_D;
  for (int idx = tid; idx < ATT_BQ * ATT_D; idx += blockDim.x) {
    const int r = idx / ATT_D, d = idx % ATT_D, qi = q0 + r;
    qs[r][d] = qi < Lq ? qb[(long long)qi * q_rs + d] : 0.f;
  }
  __syncthreads();
  if (scale_mul != nullptr) {
    // per-head q L2 norm x learned scale; each warp owns its own query rows
    const float sm = scale_mul[h];
#pragma unroll
    for (int i = 0; i < ATT_QPW; ++i) {
      const int r = warp * ATT_QPW + i;
      const float a = qs[r][lane], c = qs[r][lane + 32];
      const float inv = rsqrtf(warp_sum(a * a + c * c) + 1e-24f) * sm;
      qs[r][lane] = a * inv;
      qs[r][lane + 32] = c * inv;
    }
    __syncwarp();
  }

  float m[ATT_QPW], l[ATT_QPW], acc0[ATT_QPW], acc1[ATT_QPW];
#pragma unroll
  for (int i = 0; i < ATT_QPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc0[i] = 0.f;
    acc1[i] = 0.f;
  }

  const float* kb = k + b * kv_bs + (long long)h * ATT_D;
  const float* vb = v + b * kv_bs + (long long)h * ATT_D;
  for (int k0 = 0; k0 < Lk; k0 += ATT_BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < ATT_BK * ATT_D; idx += blockDim.x) {
      const int j = idx / ATT_D, d = idx % ATT_D, kj = k0 + j;
      const bool ok = kj < Lk;
      ks[j][d] = ok ? kb[(long long)kj * kv_rs + d] : 0.f;
      vs[j][d] = ok ? vb[(long long)kj * kv_rs + d] : 0.f;  // 0, not garbage: p = 0 there
    }
    __syncthreads();

    // logits for keys (k0 + lane) and (k0 + lane + 32)
    float s0[ATT_QPW], s1[ATT_QPW];
#pragma unroll
    for (int i = 0; i < ATT_QPW; ++i) s0[i] = s1[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < ATT_D; ++d) {
      const float ka = ks[lane][d], kc = ks[lane + 32][d];
#pragma unroll
      for (int i = 0; i < ATT_QPW; ++i) {
        const float qv = qs[warp * ATT_QPW + i][d];
        s0[i] = fmaf(qv, ka, s0[i]);
        s1[i] = fmaf(qv, kc, s1[i]);
      }
    }

    const bool ok0 = k0 + lane < Lk, ok1 = k0 + lane + 32 < Lk;
    float p0[ATT_QPW], p1[ATT_QPW];
#pragma unroll
    for (int i = 0; i < ATT_QPW; ++i) {
      const float a = ok0 ? s0[i] * scale : -INFINITY;
      const float c = ok1 ? s1[i] * scale : -INFINITY;
      const float mn = fmaxf(m[i], warp_max(fmaxf(a, c)));
      const float alpha = expf(m[i] - mn);  // 0 on the first tile (m = -inf)
      const float e0 = expf(a - mn), e1 = expf(c - mn);
      l[i] = l[i] * alpha + warp_sum(e0 + e1);
      acc0[i] *= alpha;
      acc1[i] *= alpha;
      m[i] = mn;
      p0[i] = e0;
      p1[i] = e1;
    }

    // acc[d] += sum_j p_j * v[j][d]; lane owns d = lane and lane + 32
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float va = vs[jj][lane], vc = vs[jj][lane + 32];
#pragma unroll
      for (int i = 0; i < ATT_QPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p0[i], jj);
        acc0[i] = fmaf(pj, va, acc0[i]);
        acc1[i] = fmaf(pj, vc, acc1[i]);
      }
    }
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float va = vs[32 + jj][lane], vc = vs[32 + jj][lane + 32];
#pragma unroll
      for (int i = 0; i < ATT_QPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p1[i], jj);
        acc0[i] = fmaf(pj, va, acc0[i]);
        acc1[i] = fmaf(pj, vc, acc1[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ATT_QPW; ++i) {
    const int qi = q0 + warp * ATT_QPW + i;
    if (qi < Lq) {
      float* o = out + b * o_bs + (long long)qi * o_rs + (long long)h * ATT_D;
      const float inv = 1.f / l[i];
      o[lane] = acc0[i] * inv;
      o[lane + 32] = acc1[i] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate). One block per
// (sample, head, 64-query tile), four warps of 16 queries. Per 64-key tile:
// S = Q K^T in registers, online softmax on the accumulator fragments (each
// thread holds rows g and g + 8 of its warp's 16), P rounded to bf16 and fed
// straight back as the A operand of O += P V (the S accumulator layout is
// the A fragment layout), V stored transposed in shared memory so each B
// fragment register is one 32-bit load.

#define MMA_BQ 64
#define MMA_BK 64
#define MMA_PAD 72  // bf16 row stride in shared memory: 144 bytes, 16-byte aligned

__global__ void __launch_bounds__(ATT_WARPS * 32)
decode_attention_mma_kernel(const __nv_bfloat16* __restrict__ q, long long q_bs, long long q_rs,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, long long kv_bs,
                            long long kv_rs, __nv_bfloat16* __restrict__ out, long long o_bs,
                            long long o_rs, const float* __restrict__ scale_mul, int Lq, int Lk,
                            float scale) {
  __shared__ float qf[MMA_BQ][ATT_D];
  __shared__ __align__(16) __nv_bfloat16 qb[MMA_BQ][MMA_PAD];
  __shared__ __align__(16) __nv_bfloat16 ks[MMA_BK][MMA_PAD];
  __shared__ __align__(16) __nv_bfloat16 vt[ATT_D][MMA_PAD];  // vt[d][key]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * MMA_BQ;

  const __nv_bfloat16* qbase = q + b * q_bs + (long long)h * ATT_D;
  for (int idx = tid; idx < MMA_BQ * ATT_D; idx += blockDim.x) {
    const int r = idx / ATT_D, d = idx % ATT_D, qi = q0 + r;
    qf[r][d] = qi < Lq ? __bfloat162float(qbase[(long long)qi * q_rs + d]) : 0.f;
  }
  __syncthreads();
  // per-head q L2 norm x learned scale (fp32), rounded to bf16; each warp
  // owns rows [16 warp, 16 warp + 16)
  const float sm = scale_mul != nullptr ? scale_mul[h] : 1.f;
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    float a = qf[r][lane], c = qf[r][lane + 32];
    if (scale_mul != nullptr) {
      const float inv = rsqrtf(warp_sum(a * a + c * c) + 1e-24f) * sm;
      a *= inv;
      c *= inv;
    }
    qb[r][lane] = __float2bfloat16(a);
    qb[r][lane + 32] = __float2bfloat16(c);
  }
  __syncwarp();

  const int r0 = warp * 16 + g;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = ld32(&qb[r0][kk * 16 + 2 * t]);
    qa[kk][1] = ld32(&qb[r0 + 8][kk * 16 + 2 * t]);
    qa[kk][2] = ld32(&qb[r0][kk * 16 + 8 + 2 * t]);
    qa[kk][3] = ld32(&qb[r0 + 8][kk * 16 + 8 + 2 * t]);
  }

  float o[8][4];
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) o[jd][0] = o[jd][1] = o[jd][2] = o[jd][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const __nv_bfloat16* kbase = k + b * kv_bs + (long long)h * ATT_D;
  const __nv_bfloat16* vbase = v + b * kv_bs + (long long)h * ATT_D;
  for (int k0 = 0; k0 < Lk; k0 += MMA_BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < MMA_BK * (ATT_D / 8); idx += blockDim.x) {
      const int j = idx >> 3, c8 = (idx & 7) * 8, kj = k0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);  // 0 past Lk
      if (kj < Lk) {
        kv = *reinterpret_cast<const uint4*>(kbase + (long long)kj * kv_rs + c8);
        vv = *reinterpret_cast<const uint4*>(vbase + (long long)kj * kv_rs + c8);
      }
      *reinterpret_cast<uint4*>(&ks[j][c8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[c8 + e][j] = ve[e];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t kb[2] = {ld32(&ks[j * 8 + g][kk * 16 + 2 * t]),
                                ld32(&ks[j * 8 + g][kk * 16 + 8 + 2 * t])};
        mma_bf16_16816(s[j], qa[kk], kb);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float val = col < Lk ? s[j][e] * scale : -INFINITY;
        s[j][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);  // 0 on the first tile
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - (e < 2 ? mn0 : mn1));
        s[j][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      o[jd][0] *= alpha0;
      o[jd][1] *= alpha0;
      o[jd][2] *= alpha1;
      o[jd][3] *= alpha1;
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        const uint32_t vb[2] = {ld32(&vt[jd * 8 + g][kk * 16 + 2 * t]),
                                ld32(&vt[jd * 8 + g][kk * 16 + 8 + 2 * t])};
        mma_bf16_16816(o[jd], pa, vb);
      }
    }
  }

  const int ra = q0 + r0, rb = ra + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = out + b * o_bs + (long long)h * ATT_D;
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    const int col = jd * 8 + 2 * t;
    if (ra < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)ra * o_rs + col) =
          __floats2bfloat162_rn(o[jd][0] * inv0, o[jd][1] * inv0);
    if (rb < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)rb * o_rs + col) =
          __floats2bfloat162_rn(o[jd][2] * inv1, o[jd][3] * inv1);
  }
}

extern "C" int var_decode_attention(const void* q, long long q_bs, long long q_rs, const void* k,
                                    const void* v, long long kv_bs, long long kv_rs, void* out,
                                    long long o_bs, long long o_rs, const void* scale_mul, int B,
                                    int Lq, int Lk, int H, int D, float scale, int dtype,
                                    int device, void* stream) {
  if (D != ATT_D || Lk < 1 || Lq < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(ATT_WARPS * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    const dim3 grid((unsigned)((Lq + ATT_BQ - 1) / ATT_BQ), (unsigned)H, (unsigned)B);
    decode_attention_kernel<<<grid, block, 0, st>>>(
        (const float*)q, q_bs, q_rs, (const float*)k, (const float*)v, kv_bs, kv_rs,
        (float*)out, o_bs, o_rs, (const float*)scale_mul, Lq, Lk, scale);
  } else if (dtype == kBF16) {
    // 16-byte K/V row loads: the wrapper checks alignment and strides
    const dim3 grid((unsigned)((Lq + MMA_BQ - 1) / MMA_BQ), (unsigned)H, (unsigned)B);
    decode_attention_mma_kernel<<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)q, q_bs, q_rs, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, kv_bs, kv_rs, (__nv_bfloat16*)out, o_bs, o_rs,
        (const float*)scale_mul, Lq, Lk, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
