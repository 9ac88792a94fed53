// Rows 2 and 4 of the kernel table (PERF.md): decode attention of one
// scale's queries over the KV cache.
//
// Row 2 (var_decode_attention) replaces
// var_tpu/ops/pallas/flash_attention.py::flash_decode_paired_chunks
// (_fwd_kernel_paired_chunks :476). Per (sample, head): the queries of the
// current scale attend, unmasked, to cache rows [0, Lk) -- every earlier
// stage plus the current one, which the caller has already written. q is
// read from the first C lanes of the fused (B, Lq, 3C) qkv projection (row
// stride 3C, never copied out). With ``scale_mul`` the per-head q L2 norm
// times the learned scale runs here (k is normalised when the cache is
// written); ``scale`` multiplies the logits after the dot.
//
// Row 4 (var_decode_attention_paired) replaces
// var_tpu/ops/pallas/flash_attention.py::flash_decode_paired
// (_fwd_kernel_paired :426): the same softmax(q k^T) v over a merged
// (B, Lk, C) cache, with ``scale`` folded into q before the dot and rounded
// to q's dtype (flash_attention.py:658). With ``scale_mul`` it also takes
// the q norm that JAX's caller runs before it (_split_norm,
// var_tpu/models/var.py:293): fp32 q * rsqrt(sum q^2 + 1e-24) * scale_mul,
// rounded to q's dtype, then * scale, rounded again -- so q may be the fused
// qkv here too. It is the kPaired instantiation of the same device code: the
// rows of the cache it reads are [0, Lk) of one layer's in-place buffer,
// which holds the prealloc/concat caches and the kv_window-pruned window.
//
// Logits, softmax and the running sums are fp32; with bf16 inputs q and the
// softmax weights are rounded to bf16 before their products, as the TPU
// kernels feed bf16 operands to the MXU; fp32 inputs stay fp32 throughout.
// The paired-head 128-lane packing, scalar-prefetched layer index and VMEM
// budget of the TPU kernels are Mosaic workarounds and have no counterpart:
// the caller passes the layer's cache base pointer and strides, and every
// stage is served, l < 8 and long caches included.
//
// Bound on the H100: memory. At the last 256px stage (2B = 16, Lq = 256,
// Lk = 680, 16 heads of 64, bf16) the kernel must read q (8.4 MB of the
// fused qkv), K and V (44.6 MB) and write the output (8.4 MB): 61.3 MB,
// 18.3 us at 3.35 TB/s, against 11.4 GFLOP, 11.5 us on the tensor cores at
// 989 TF. Both are close, and the softmax's 45 M exponentials take about as
// long on the SFUs, so the design keeps the copies, the tensor cores and the
// SFUs busy at once:
//   * bf16 (the sampling path, decode_attention_wgmma_kernel): one
//     warpgroup per (sample, head, 64-query tile), four blocks per SM (106
//     registers, 49 KB of shared memory). Thread 0 streams 64-key K and V
//     tiles with TMA (cp.async.bulk.tensor) into two rings in dynamic shared
//     memory -- 2 K stages, 3 V stages -- each stage completing on an
//     mbarrier; a stage is refilled as soon as every warp is past its last
//     reader, so each tile is in flight for two iterations and the loop has
//     one 128-thread barrier, no block-wide one. The tensor maps have Lk
//     rows, so the rows of the last tile past Lk arrive as zeros and stale
//     or NaN rows of the in-place buffer never reach P V. Tiles land
//     128-byte swizzled, as wgmma reads them without bank conflicts. q is
//     read once with 16-byte loads, normalised in fp32 where asked, rounded
//     to bf16 and written into the swizzled Q tile: no fp32 staging.
//     S = Q K^T is 4 wgmma m64n64k16 per tile from shared memory; the online
//     softmax runs on the fp32 accumulator in registers (the row max on the
//     raw logits, then one fused multiply-add by the scale times log2 e and
//     one ex2 per logit); P, rounded to bf16, is the register A
//     operand of O += P V, whose B is the V tile in its natural (key, d)
//     layout through the descriptor's transpose bit -- no element transpose
//     anywhere. Within a warpgroup, tile i's softmax runs while the tensor
//     cores still compute tile i-1's P V; across the blocks of an SM, one's
//     softmax overlaps another's products and copies. Measured on the H100
//     (PERF.md section 6): blocks of two warpgroups sharing each K/V tile halve
//     L2-to-SM traffic but ran slower (fewer blocks per SM, the slower
//     warpgroup holding the ring), as did a producer warp with "empty"
//     barriers and a single 4-stage K+V ring. Host work per launch: two
//     tensor-map encodings.
//   * fp32 (the parity path, decode_attention_kernel): the same algorithm on
//     the CUDA cores in full fp32, 16-query tiles, synchronous loads;
//     tensor-core TF32 would round the logits.

#include <float.h>

#include "common.cuh"

using namespace vtt;

#define ATT_D 64
#define ATT_BQ 16
#define ATT_BK 64
#define ATT_WARPS 4
#define ATT_QPW (ATT_BQ / ATT_WARPS)

// fp32: CUDA cores, 16-query tiles, four warps of four queries; K/V tiles
// in shared memory, keys (k0 + lane) and (k0 + lane + 32) per lane.
template <bool kPaired>
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
  if (scale_mul != nullptr || kPaired) {
    // per-head q L2 norm x learned scale, then row 4's pre-dot scale; each
    // warp owns its own query rows
    const float sm = scale_mul != nullptr ? scale_mul[h] : 1.f;
#pragma unroll
    for (int i = 0; i < ATT_QPW; ++i) {
      const int r = warp * ATT_QPW + i;
      float a = qs[r][lane], c = qs[r][lane + 32];
      if (scale_mul != nullptr) {
        const float inv = rsqrtf(warp_sum(a * a + c * c) + 1e-24f) * sm;
        a *= inv;
        c *= inv;
      }
      if (kPaired) {
        a *= scale;
        c *= scale;
      }
      qs[r][lane] = a;
      qs[r][lane + 32] = c;
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
      const float a = ok0 ? (kPaired ? s0[i] : s0[i] * scale) : -INFINITY;
      const float c = ok1 ? (kPaired ? s1[i] : s1[i] * scale) : -INFINITY;
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
// bf16: warpgroup MMA over TMA rings (see the note at the top). Dynamic
// shared memory, from a 1024-byte aligned base: the Q tile, DEC_KSTAGES K
// tiles, DEC_VSTAGES V tiles, each 64 rows of 128 bytes (8 KB), 128-byte
// swizzled, then one mbarrier per stage.

#define DEC_BQ 64                 // queries per block: one warpgroup
#define DEC_BK 64                 // keys per tile
#define DEC_KSTAGES 2             // K tiles in their ring
#define DEC_VSTAGES 3             // V tiles in theirs
#define DEC_TILE (64 * ATT_D * 2) // bytes of one swizzled 64 x 64 bf16 tile
#define DEC_LOG2E 1.4426950408889634f
// Q, the K ring, the V ring; + room to align the base, + the mbarriers
#define DEC_SMEM ((1 + DEC_KSTAGES + DEC_VSTAGES) * DEC_TILE + 1024 + \
                  (DEC_KSTAGES + DEC_VSTAGES) * 8)

template <bool kPaired>
__global__ void __launch_bounds__(128)
decode_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __nv_bfloat16* __restrict__ q, long long q_bs,
                              long long q_rs, __nv_bfloat16* __restrict__ out, long long o_bs,
                              long long o_rs, const float* __restrict__ scale_mul, int Lq,
                              int Lk, float scale) {
  extern __shared__ uint8_t dec_smem[];
  const uint32_t base = (smem_u32(dec_smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index, broadcast from lane 0 so that the compiler sees it (and
  // every branch on it) as warp-uniform; a branch it cannot prove uniform
  // around wgmma makes ptxas serialise every wgmma
  const int wq = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * DEC_BQ;
  const uint32_t sq = base;
  const uint32_t sk = sq + DEC_TILE;
  const uint32_t sv = sk + DEC_KSTAGES * DEC_TILE;
  const uint32_t kfull = sv + DEC_VSTAGES * DEC_TILE;  // + 8 s: K tile of stage s landed
  const uint32_t vfull = kfull + DEC_KSTAGES * 8;      // + 8 s: V tile of stage s landed
  const int ntiles = (Lk + DEC_BK - 1) / DEC_BK;
  // thread 0 copies tile t of K or V into its stage with TMA; rows >= Lk
  // lie outside the tensor maps and arrive as zeros
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t bars, int stages, int t) {
    const int ps = t % stages;
    mbar_arrive_expect_tx(bars + 8 * ps, DEC_TILE);
    tma_load_3d(ring + ps * DEC_TILE, map, bars + 8 * ps, h * ATT_D, t * DEC_BK, b);
  };

  if (tid == 0) {
    for (int s = 0; s < DEC_KSTAGES; ++s) mbar_init(kfull + 8 * s, 1);
    for (int s = 0; s < DEC_VSTAGES; ++s) mbar_init(vfull + 8 * s, 1);
    mbar_init_fence();
    for (int t = 0; t < DEC_KSTAGES && t < ntiles; ++t) load(&tm_k, sk, kfull, DEC_KSTAGES, t);
    load(&tm_v, sv, vfull, DEC_VSTAGES, 0);
  }

  // q: 16-byte loads, 8 lanes per row, four rows per pass; per-head fp32
  // norm x scale_mul where asked, rounded to bf16; row 4 then folds the
  // scale in and rounds again; row 2 negates q (exactly) for a negative
  // scale, so that the factor the softmax applies is never negative;
  // written into the swizzled Q tile
  {
    const float sm = scale_mul != nullptr ? scale_mul[h] : 1.f;
    const float qsign = !kPaired && scale < 0.f ? -1.f : 1.f;
    const int sub = lane >> 3, c = lane & 7;
    const __nv_bfloat16* qb = q + b * q_bs + (long long)h * ATT_D + c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wq * 16 + i * 4 + sub, qi = q0 + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (qi < Lq) raw = *reinterpret_cast<const uint4*>(qb + (long long)qi * q_rs);
      __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&raw);
      float x[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pr[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
      if (scale_mul != nullptr) {
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) ss = fmaf(x[e], x[e], ss);
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        ss += __shfl_xor_sync(0xffffffffu, ss, 4);
        const float inv = rsqrtf(ss + 1e-24f) * sm;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = rnd<__nv_bfloat16>(x[e] * inv);
      }
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pw[e] = kPaired ? pack_bf16(x[2 * e] * scale, x[2 * e + 1] * scale)
                        : pack_bf16(x[2 * e] * qsign, x[2 * e + 1] * qsign);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(sq + sw128(r, c)),
                   "r"(packed.x), "r"(packed.y), "r"(packed.z), "r"(packed.w)
                   : "memory");
    }
    fence_proxy_async();
  }
  __syncthreads();  // the Q tile is written and the barriers are initialised

  // row 2 scales the logits after the dot; both rows work in log2 units.
  // c2 > 0 (FLT_MIN for a zero scale: every weight still comes out 1), so
  // the largest scaled logit is c2 times the largest logit, and a logit
  // masked to -inf scales to -inf
  const float c2 = fmaxf((kPaired ? 1.f : fabsf(scale)) * DEC_LOG2E, FLT_MIN);
  const uint64_t dq = wgmma_desc_sw128(sq, 16, 1024);
  float o[32], s[32];
  uint32_t pa[4][4];  // P of the previous tile in bf16, the A operand of O += P V
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  float alpha0 = 1.f, alpha1 = 1.f;
  // Online softmax of the logits of tile ``it`` in s, in place: s becomes
  // p = exp2(c2 s - m) in fp32, one fused multiply-add and one ex2 per
  // logit; m (in scaled units), l (this thread's share of the row sums) and
  // alpha, the factor O must take before this tile's P V, move on.
  auto softmax = [&](int it) {
    const int kq = it * DEC_BK;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[4 * j + e];
        if (kq + DEC_BK > Lk && kq + 8 * j + 2 * tq + (e & 1) >= Lk) t = -INFINITY;
        s[4 * j + e] = t;
        if (e < 2) mx0 = fmaxf(mx0, t); else mx1 = fmaxf(mx1, t);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * c2), mn1 = fmaxf(m1, mx1 * c2);
    alpha0 = fast_exp2(m0 - mn0);  // 0 on the first tile (m = -inf)
    alpha1 = fast_exp2(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[4 * j + e], c2, -(e < 2 ? mn0 : mn1)));
        s[4 * j + e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
  };
  // O *= alpha, then P (in s) rounded to bf16 into the A fragments: keys
  // 16 kk .. 16 kk + 15 are the accumulator's n8 tiles 2 kk and 2 kk + 1
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // O += P V over V tile ``t``, once it has landed: B stored [key][d] =
  // [k][n], MN-major; one 1024-byte atom spans all 64 d and 8-key groups are
  // 1024 bytes apart (either offset field may carry it); 16 keys per step
  auto issue_pv = [&](int t) {
    const int vst = t % DEC_VSTAGES;
    mbar_wait(vfull + 8 * vst, (t / DEC_VSTAGES) & 1);
    const uint64_t dv = wgmma_desc_sw128(sv + vst * DEC_TILE, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs_tb(o, pa[kk], dv + 128 * kk);
    wgmma_commit();
  };

  // Iteration it: S = Q K_it^T is issued once K_it has landed, then
  // O += P_{it-1} V_{it-1}. When S is done, K_it's stage and V_{it-2}'s are
  // free: thread 0 refills them with K_{it+2} and V_{it+1}, so each tile is
  // in flight for two iterations. The softmax of S runs while the tensor
  // cores still work on P V; O is rescaled once P V is done.
  for (int it = 0; it < ntiles; ++it) {
    const int kst = it % DEC_KSTAGES;
    mbar_wait(kfull + 8 * kst, (it / DEC_KSTAGES) & 1);
    // K tile: B of S = Q K^T stored [key][d], K-major; 16 of d (32 bytes
    // along the swizzled row) per step
    const uint64_t dk = wgmma_desc_sw128(sk + kst * DEC_TILE, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
    if (it > 0) {
      issue_pv(it - 1);
      wgmma_wait<1>();  // S is done; P V may still run
    } else {
      wgmma_wait<0>();
    }
    wgmma_fence_regs(s);
    named_barrier(1, 128);  // every warp is past S_it and P_{it-2} V_{it-2}
    if (tid == 0) {
      if (it + DEC_KSTAGES < ntiles) load(&tm_k, sk, kfull, DEC_KSTAGES, it + DEC_KSTAGES);
      if (it + 1 < ntiles) load(&tm_v, sv, vfull, DEC_VSTAGES, it + 1);
    }
    softmax(it);
    wgmma_wait<0>();
    wgmma_fence_regs(o);
    rescale_and_pack();
  }
  wgmma_fence();
  issue_pv(ntiles - 1);
  wgmma_wait<0>();
  wgmma_fence_regs(o);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int ra = q0 + wq * 16 + g, rb = ra + 8;
  __nv_bfloat16* ob = out + b * o_bs + (long long)h * ATT_D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (ra < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)ra * o_rs + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (rb < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)rb * o_rs + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <bool kPaired>
static int launch_decode_attention(const void* q, long long q_bs, long long q_rs, const void* k,
                                   const void* v, long long kv_bs, long long kv_rs, void* out,
                                   long long o_bs, long long o_rs, const void* scale_mul, int B,
                                   int Lq, int Lk, int H, int D, float scale, int dtype,
                                   int device, void* stream) {
  if (D != ATT_D || Lk < 1 || Lq < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    const dim3 grid((unsigned)((Lq + ATT_BQ - 1) / ATT_BQ), (unsigned)H, (unsigned)B);
    decode_attention_kernel<kPaired><<<grid, ATT_WARPS * 32, 0, st>>>(
        (const float*)q, q_bs, q_rs, (const float*)k, (const float*)v, kv_bs, kv_rs,
        (float*)out, o_bs, o_rs, (const float*)scale_mul, Lq, Lk, scale);
  } else if (dtype == kBF16) {
    // 16-byte aligned q rows and K/V rows, strides in multiples of 16 bytes:
    // the wrapper checks them (TMA needs them too)
    CUtensorMap tm_k, tm_v;
    if ((err = tile_tensor_map(&tm_k, k, kv_bs, kv_rs, B, Lk, H)) != cudaSuccess ||
        (err = tile_tensor_map(&tm_v, v, kv_bs, kv_rs, B, Lk, H)) != cudaSuccess)
      return (int)err;
    static bool ready[64] = {};  // the shared-memory attribute, set once per device
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (!ready[device]) {
      err = cudaFuncSetAttribute(decode_attention_wgmma_kernel<kPaired>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, DEC_SMEM);
      if (err != cudaSuccess) return (int)err;
      ready[device] = true;
    }
    const dim3 grid((unsigned)((Lq + DEC_BQ - 1) / DEC_BQ), (unsigned)H, (unsigned)B);
    decode_attention_wgmma_kernel<kPaired><<<grid, 128, DEC_SMEM, st>>>(
        tm_k, tm_v, (const __nv_bfloat16*)q, q_bs, q_rs, (__nv_bfloat16*)out, o_bs, o_rs,
        (const float*)scale_mul, Lq, Lk, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Row 2: q read from the fused qkv, optional in-kernel q L2 norm, post-dot scale.
extern "C" int var_decode_attention(const void* q, long long q_bs, long long q_rs, const void* k,
                                    const void* v, long long kv_bs, long long kv_rs, void* out,
                                    long long o_bs, long long o_rs, const void* scale_mul, int B,
                                    int Lq, int Lk, int H, int D, float scale, int dtype,
                                    int device, void* stream) {
  return launch_decode_attention<false>(q, q_bs, q_rs, k, v, kv_bs, kv_rs, out, o_bs, o_rs,
                                        scale_mul, B, Lq, Lk, H, D, scale, dtype, device, stream);
}

// Row 4: optional in-kernel q L2 norm, then the scale folded into q.
extern "C" int var_decode_attention_paired(const void* q, long long q_bs, long long q_rs,
                                           const void* k, const void* v, long long kv_bs,
                                           long long kv_rs, void* out, long long o_bs,
                                           long long o_rs, const void* scale_mul, int B, int Lq,
                                           int Lk, int H, int D, float scale, int dtype,
                                           int device, void* stream) {
  return launch_decode_attention<true>(q, q_bs, q_rs, k, v, kv_bs, kv_rs, out, o_bs, o_rs,
                                       scale_mul, B, Lq, Lk, H, D, scale, dtype, device, stream);
}
