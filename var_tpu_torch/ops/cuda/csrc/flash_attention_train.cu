// Rows 5 and 6 of the kernel table (PERF.md): teacher-forced attention,
// forward and backward, over one layout that serves both.
//
// Row 6 (kRow = 6, entries var_ptrain_*) replaces
// var_tpu/ops/pallas/flash_attention.py::flash_attention_paired_train
// (:1144): the forward _fwd_kernel_ptrain (:700, pallas_call :912) and the
// backward _bwd_fused_kernel_ptrain (:941, :1071) or _bwd_dq_kernel_ptrain
// (:775, :1092) with _bwd_dkv_kernel_ptrain (:838, :1108).
// Row 5 (kRow = 5, entries var_flash_*) replaces the streaming BLHD kernel
// flash_attention.py::flash_attention (:375): _fwd (:190, pallas_call :194),
// the dq pass (:305) and the dk/dv pass (:324) of its VJP. A BLHD-contiguous
// (B, L, H, 64) tensor is exactly the merged (B, L, C) layout below, so the
// two rows are two instantiations of the same device code: the TPU's
// differences between them (row 5 transposes to (B*H, L, D) and streams K in
// _pick_block_k blocks with 128-lane scratch, row 6 packs head pairs into
// 128 lanes) are Mosaic layout choices with no counterpart here. kRow gives
// each row its own kernel symbols, so profiles and launch counts tell them
// apart. Row 5 also serves the unmasked Lq != Lk case (no ends: every key
// visible, the loops run over all Lk keys and all Lq queries) and L up to
// 9451 (1024px): row and batch offsets are 64-bit, shared memory does not
// grow with L.
//
// Function: q, k, v merged (B, L, C), head h in lanes [64h, 64h + 64), q
// already multiplied by the softmax scale (the caller rounds q * scale to the
// input dtype first, flash_attention.py:1182). Key j is visible from query i
// iff level(j) <= level(i), level(p) = #{e in ends : p >= e}; with no ends
// every key is visible. Forward: out and the per-(row, head) log-sum-exp
// lse (B, H, L) fp32. Backward (FlashAttention-2 style): p = exp(s - lse) is
// recomputed, delta = sum_d do * o per (row, head) comes from the caller, then
//   dv = p^T do,   ds = p * (do v^T - delta),   dq = ds k,   dk = ds^T q.
// Logits, softmax and every accumulator are fp32. With bf16 inputs p and ds
// are rounded to bf16 before their products, as the TPU kernels feed bf16
// operands to the MXU; fp32 inputs stay fp32 (CUDA cores, no TF32).
// The TPU kernels' paired-head 128-lane packing, _paired_col relayouts, VMEM
// fused-vs-split dispatch and Python-level segmentation are Mosaic
// workarounds and have no counterpart here.
//
// Bound on the H100 at d16, batch 32, 256px (L = 680): memory, barely. The
// useful work is sum_s n_s * e_s = 286434 of the L^2 = 462400 (query, key)
// pairs (62%): forward 4 B H D sum n_s e_s = 37.5 GFLOP (38 us of tensor
// cores) against 179.7 MB of q, k, v, out and lse (54 us); backward
// 93.9 GFLOP (95 us) against 359 MB (107 us). At 512px (batch 8, L = 2240,
// 65% of the pairs useful) and 1024px (batch 2, L = 9451) the tensor cores
// bound it: forward 107 GFLOP (108 us) and 467 GFLOP (472 us).
// Design, right first and simple:
//  * the mask's structure bounds every loop: a query tile visits key tiles
//    only up to ends[level(its last query)], a key tile visits query tiles
//    only from the start of its first key's scale, so most pairs the mask
//    kills are never loaded; the in-tile mask and the rows past L (the TPU
//    kernels' qrow_ok / krow_ok) are evaluated per element;
//  * bf16: four warps of 16 rows, every product on the tensor cores with
//    mma.sync m16n8k16 (common.cuh). Forward and dQ: one block per (batch,
//    head, 64-query tile) looping over key tiles; dK/dV: one block per
//    (batch, head, 64-key tile) looping over query tiles -- deterministic,
//    no atomics;
//  * fp32: the same three passes on the CUDA cores, 16-row tiles, lanes
//    over keys (or queries) and over head dims.
// Loads are synchronous; cp.async/TMA pipelining and wgmma are left for a
// tuning pass.

#include "common.cuh"

using namespace vtt;

typedef __nv_bfloat16 bf16;

#define PT_D 64          // head dim served
#define PT_T 64          // rows per tile of the bf16 kernels, keys per tile everywhere
#define PT_PAD 72        // bf16 shared row stride: 144 bytes, 16-byte aligned
#define PT_FROWS 16      // rows per block of the fp32 kernels (4 per warp)
#define PT_FRPW 4
#define PT_MAX_ENDS 32

struct Ends {
  int n;
  int e[PT_MAX_ENDS];  // ascending scale ends
};

__device__ __forceinline__ int level_of(const Ends& s, int p) {
  int lv = 0;
  for (int i = 0; i < s.n; ++i) lv += p >= s.e[i] ? 1 : 0;
  return lv;
}

// Keys visible from query i: [0, key_end(i)).
__device__ __forceinline__ int key_end(const Ends& s, int i, int Lk) {
  const int lv = level_of(s, i);
  return lv < s.n ? min(s.e[lv], Lk) : Lk;
}

// First query that sees key j: the start of j's scale.
__device__ __forceinline__ int query_begin(const Ends& s, int j) {
  const int lv = level_of(s, j);
  return lv == 0 ? 0 : s.e[lv - 1];
}

// ---------------------------------------------------------------------------
// bf16 helpers (fragment layout in common.cuh)

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Rows [r0, r0 + 64) of one head (src points at lane 64h of row 0) of a
// merged (L, C) matrix into shared memory, row-major dst[row][d] and/or
// transposed dst_t[d][row]. Rows at or past L load as zeros.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int C, int r0, int L,
                                          bf16 (*dst)[PT_PAD], bf16 (*dst_t)[PT_PAD]) {
  for (int idx = threadIdx.x; idx < PT_T * (PT_D / 8); idx += blockDim.x) {
    const int j = idx >> 3, c8 = (idx & 7) * 8, r = r0 + j;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < L) val = *reinterpret_cast<const uint4*>(src + (long long)r * C + c8);
    if (dst != nullptr) *reinterpret_cast<uint4*>(&dst[j][c8]) = val;
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) dst_t[c8 + u][j] = e[u];
    }
  }
}

// A-operand fragments of this thread's rows r and r + 8, all 64 head dims,
// straight from device memory; rows at or past L are 0.
__device__ __forceinline__ void load_a(const bf16* __restrict__ src, int C, int r, int L,
                                       uint32_t (&a)[4][4]) {
  const int t = threadIdx.x & 3;
  const bool ok0 = r < L, ok1 = r + 8 < L;
  const bf16* p0 = src + (long long)r * C;
  const bf16* p1 = src + (long long)(r + 8) * C;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = ok0 ? ld32(p0 + c) : 0u;
    a[kk][1] = ok1 ? ld32(p1 + c) : 0u;
    a[kk][2] = ok0 ? ld32(p0 + c + 8) : 0u;
    a[kk][3] = ok1 ? ld32(p1 + c + 8) : 0u;
  }
}

// Accumulator tiles of one product rounded to bf16 as the A operand of the next.
__device__ __forceinline__ void pack_a(const float (&s)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc (16 x 64) += A (16 x 64) * B (64 x 64), B stored bs[n][k].
__device__ __forceinline__ void mma_acc(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16 (*bs)[PT_PAD]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t b[2] = {ld32(&bs[j * 8 + g][kk * 16 + 2 * t]),
                             ld32(&bs[j * 8 + g][kk * 16 + 8 + 2 * t])};
      mma_bf16_16816(acc[j], a[kk], b);
    }
  }
}

// Rows r and r + 8 of a 16 x 64 accumulator to a merged (L, C) bf16 matrix.
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int C, int r, int L,
                                           const float (&acc)[8][4], float s0, float s1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    const int col = jd * 8 + 2 * t;
    if (r < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * C + col) =
          __floats2bfloat162_rn(acc[jd][0] * s0, acc[jd][1] * s0);
    if (r + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r + 8) * C + col) =
          __floats2bfloat162_rn(acc[jd][2] * s1, acc[jd][3] * s1);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: block = (64-query tile, head, batch), warp = 16 queries.

template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                      int Lq, int Lk, int H, Ends ends) {
  __shared__ __align__(16) bf16 ks[PT_T][PT_PAD];  // K [key][d]: B of s = q k^T
  __shared__ __align__(16) bf16 vt[PT_D][PT_PAD];  // V^T [d][key]: B of o += p v

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * PT_T;
  const int C = H * PT_D;
  const bf16* qb = q + (long long)b * Lq * C + h * PT_D;
  const bf16* kb = k + (long long)b * Lk * C + h * PT_D;
  const bf16* vb = v + (long long)b * Lk * C + h * PT_D;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const int kend_a = key_end(ends, min(ra, Lq - 1), Lk);
  const int kend_b = key_end(ends, min(rb, Lq - 1), Lk);
  const int kend = key_end(ends, min(q0 + PT_T - 1, Lq - 1), Lk);

  uint32_t qa[4][4];
  load_a(qb, C, ra, Lq, qa);
  float o[8][4];
  zero_acc(o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < kend; k0 += PT_T) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile(kb, C, k0, Lk, ks, nullptr);
    load_tile(vb, C, k0, Lk, nullptr, vt);
    __syncthreads();

    float s[8][4];
    zero_acc(s);
    mma_acc(s, qa, ks);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const float val = col < (e < 2 ? kend_a : kend_b) ? s[j][e] : -INFINITY;
        s[j][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key 0 is visible from every query, so m is finite after the first tile
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
    uint32_t pa[4][4];
    pack_a(s, pa);
    mma_acc(o, pa, vt);
  }

  const float la = l0 > 0.f ? l0 : 1.f, lb = l1 > 0.f ? l1 : 1.f;
  store_rows(out + (long long)b * Lq * C + h * PT_D, C, ra, Lq, o, 1.f / la, 1.f / lb);
  if (t == 0) {
    float* lse_bh = lse + ((long long)b * H + h) * Lq;
    if (ra < Lq) lse_bh[ra] = m0 + logf(la);
    if (rb < Lq) lse_bh[rb] = m1 + logf(lb);
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ: block = (64-query tile, head, batch), warp = 16 queries, the same
// key tiles as the forward.

template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int Lq, int Lk, int H, Ends ends) {
  __shared__ __align__(16) bf16 ks[PT_T][PT_PAD];  // K [key][d]: B of s = q k^T
  __shared__ __align__(16) bf16 vs[PT_T][PT_PAD];  // V [key][d]: B of dp = do v^T
  __shared__ __align__(16) bf16 kt[PT_D][PT_PAD];  // K^T [d][key]: B of dq += ds k

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * PT_T;
  const int C = H * PT_D;
  const long long qoff = (long long)b * Lq * C + h * PT_D;
  const bf16* kb = k + (long long)b * Lk * C + h * PT_D;
  const bf16* vb = v + (long long)b * Lk * C + h * PT_D;
  const float* lse_bh = lse + ((long long)b * H + h) * Lq;
  const float* dlt_bh = delta + ((long long)b * H + h) * Lq;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const int kend_a = key_end(ends, min(ra, Lq - 1), Lk);
  const int kend_b = key_end(ends, min(rb, Lq - 1), Lk);
  const int kend = key_end(ends, min(q0 + PT_T - 1, Lq - 1), Lk);
  const float lse_a = ra < Lq ? lse_bh[ra] : 0.f, lse_b = rb < Lq ? lse_bh[rb] : 0.f;
  const float dlt_a = ra < Lq ? dlt_bh[ra] : 0.f, dlt_b = rb < Lq ? dlt_bh[rb] : 0.f;

  uint32_t qa[4][4], da[4][4];
  load_a(q + qoff, C, ra, Lq, qa);
  load_a(dout + qoff, C, ra, Lq, da);
  float acc[8][4];
  zero_acc(acc);

  for (int k0 = 0; k0 < kend; k0 += PT_T) {
    __syncthreads();
    load_tile(kb, C, k0, Lk, ks, kt);
    load_tile(vb, C, k0, Lk, vs, nullptr);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_acc(s, qa, ks);
    mma_acc(dp, da, vs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool valid = col < (lo ? kend_a : kend_b);
        const float p = valid ? expf(s[j][e] - (lo ? lse_a : lse_b)) : 0.f;
        const float dlt = lo ? dlt_a : dlt_b;
        s[j][e] = valid ? p * (dp[j][e] - dlt) : 0.f;  // ds
      }
    }
    uint32_t dsa[4][4];
    pack_a(s, dsa);
    mma_acc(acc, dsa, kt);
  }
  store_rows(dq + qoff, C, ra, Lq, acc, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// bf16 dK/dV: block = (64-key tile, head, batch), warp = 16 keys, looping
// over the query tiles that can see the tile.

template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int H,
                      Ends ends) {
  __shared__ __align__(16) bf16 qs[PT_T][PT_PAD];   // Q [query][d]: B of s^T = k q^T
  __shared__ __align__(16) bf16 qt[PT_D][PT_PAD];   // Q^T [d][query]: B of dk += ds^T q
  __shared__ __align__(16) bf16 dos[PT_T][PT_PAD];  // dO [query][d]: B of dp^T = v do^T
  __shared__ __align__(16) bf16 dot_t[PT_D][PT_PAD];  // dO^T [d][query]: B of dv += p^T do
  __shared__ float lse_s[PT_T], dlt_s[PT_T];
  __shared__ int kend_s[PT_T];  // keys visible from each query of the tile (0 past Lq)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * PT_T;
  const int C = H * PT_D;
  const bf16* qb = q + (long long)b * Lq * C + h * PT_D;
  const bf16* dob = dout + (long long)b * Lq * C + h * PT_D;
  const long long koff = (long long)b * Lk * C + h * PT_D;
  const float* lse_bh = lse + ((long long)b * H + h) * Lq;
  const float* dlt_bh = delta + ((long long)b * H + h) * Lq;
  const int ra = k0 + warp * 16 + g, rb = ra + 8;  // this thread's key rows

  uint32_t ka[4][4], va[4][4];
  load_a(k + koff, C, ra, Lk, ka);
  load_a(v + koff, C, ra, Lk, va);
  float dk_acc[8][4], dv_acc[8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  for (int q0 = query_begin(ends, k0) / PT_T * PT_T; q0 < Lq; q0 += PT_T) {
    __syncthreads();
    load_tile(qb, C, q0, Lq, qs, qt);
    load_tile(dob, C, q0, Lq, dos, dot_t);
    if (threadIdx.x < PT_T) {
      const int i = q0 + threadIdx.x;
      const bool ok = i < Lq;
      lse_s[threadIdx.x] = ok ? lse_bh[i] : 0.f;
      dlt_s[threadIdx.x] = ok ? dlt_bh[i] : 0.f;
      kend_s[threadIdx.x] = ok ? key_end(ends, i, Lk) : 0;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_acc(s, ka, qs);
    mma_acc(dp, va, dos);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const bool valid = (e < 2 ? ra : rb) < kend_s[c];
        const float p = valid ? expf(s[j][e] - lse_s[c]) : 0.f;
        const float dlt = dlt_s[c];
        s[j][e] = p;
        dp[j][e] = valid ? p * (dp[j][e] - dlt) : 0.f;  // ds
      }
    }
    uint32_t a[4][4];
    pack_a(s, a);
    mma_acc(dv_acc, a, dot_t);
    pack_a(dp, a);
    mma_acc(dk_acc, a, qt);
  }
  store_rows(dk + koff, C, ra, Lk, dk_acc, 1.f, 1.f);
  store_rows(dv + koff, C, ra, Lk, dv_acc, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// fp32 (CUDA cores): blocks of 16 rows, four warps of four rows; a row's
// products with the 64 columns of a tile are split over lanes (columns lane
// and lane + 32), its sums over a tile's rows into head dims lane and
// lane + 32 by shuffles.

// Rows [r0, r0 + n) of one head of a merged (L, C) fp32 matrix into dst
// (row stride ld); rows at or past L load as zeros.
__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src, int C, int r0, int n,
                                              int L, float* dst, int ld) {
  for (int idx = threadIdx.x; idx < n * PT_D; idx += blockDim.x) {
    const int j = idx / PT_D, d = idx % PT_D, r = r0 + j;
    dst[j * ld + d] = r < L ? src[(long long)r * C + d] : 0.f;
  }
}

template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int H, Ends ends) {
  __shared__ float qs[PT_FROWS][PT_D];
  __shared__ float ks[PT_T][PT_D + 1];  // +1: lane-indexed rows hit distinct banks
  __shared__ float vs[PT_T][PT_D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * PT_FROWS;
  const int C = H * PT_D;
  const long long qoff = (long long)b * Lq * C + h * PT_D;
  const float* kb = k + (long long)b * Lk * C + h * PT_D;
  const float* vb = v + (long long)b * Lk * C + h * PT_D;
  load_rows_f32(q + qoff, C, q0, PT_FROWS, Lq, &qs[0][0], PT_D);
  const int kend = key_end(ends, min(q0 + PT_FROWS - 1, Lq - 1), Lk);
  int kr[PT_FRPW];
  float m[PT_FRPW], l[PT_FRPW], acc0[PT_FRPW], acc1[PT_FRPW];
#pragma unroll
  for (int i = 0; i < PT_FRPW; ++i) {
    kr[i] = key_end(ends, min(q0 + warp * PT_FRPW + i, Lq - 1), Lk);
    m[i] = -INFINITY;
    l[i] = acc0[i] = acc1[i] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += PT_T) {
    __syncthreads();
    load_rows_f32(kb, C, k0, PT_T, Lk, &ks[0][0], PT_D + 1);
    load_rows_f32(vb, C, k0, PT_T, Lk, &vs[0][0], PT_D);
    __syncthreads();

    float s0[PT_FRPW], s1[PT_FRPW];
#pragma unroll
    for (int i = 0; i < PT_FRPW; ++i) s0[i] = s1[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < PT_D; ++d) {
      const float ka = ks[lane][d], kc = ks[lane + 32][d];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float qv = qs[warp * PT_FRPW + i][d];
        s0[i] = fmaf(qv, ka, s0[i]);
        s1[i] = fmaf(qv, kc, s1[i]);
      }
    }
    float p0[PT_FRPW], p1[PT_FRPW];
#pragma unroll
    for (int i = 0; i < PT_FRPW; ++i) {
      const float a = k0 + lane < kr[i] ? s0[i] : -INFINITY;
      const float c = k0 + lane + 32 < kr[i] ? s1[i] : -INFINITY;
      const float mn = fmaxf(m[i], warp_max(fmaxf(a, c)));
      const float alpha = expf(m[i] - mn);
      const float e0 = expf(a - mn), e1 = expf(c - mn);
      l[i] = l[i] * alpha + warp_sum(e0 + e1);
      acc0[i] *= alpha;
      acc1[i] *= alpha;
      m[i] = mn;
      p0[i] = e0;
      p1[i] = e1;
    }
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float va = vs[jj][lane], vc = vs[jj][lane + 32];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p0[i], jj);
        acc0[i] = fmaf(pj, va, acc0[i]);
        acc1[i] = fmaf(pj, vc, acc1[i]);
      }
    }
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float va = vs[32 + jj][lane], vc = vs[32 + jj][lane + 32];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p1[i], jj);
        acc0[i] = fmaf(pj, va, acc0[i]);
        acc1[i] = fmaf(pj, vc, acc1[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PT_FRPW; ++i) {
    const int qi = q0 + warp * PT_FRPW + i;
    if (qi < Lq) {
      const float li = l[i] > 0.f ? l[i] : 1.f;
      float* o = out + qoff + (long long)qi * C;
      o[lane] = acc0[i] / li;
      o[lane + 32] = acc1[i] / li;
      if (lane == 0) lse[((long long)b * H + h) * Lq + qi] = m[i] + logf(li);
    }
  }
}

template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int Lq, int Lk, int H, Ends ends) {
  __shared__ float qs[PT_FROWS][PT_D];
  __shared__ float dos[PT_FROWS][PT_D];
  __shared__ float ks[PT_T][PT_D + 1];
  __shared__ float vs[PT_T][PT_D + 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * PT_FROWS;
  const int C = H * PT_D;
  const long long qoff = (long long)b * Lq * C + h * PT_D;
  const float* kb = k + (long long)b * Lk * C + h * PT_D;
  const float* vb = v + (long long)b * Lk * C + h * PT_D;
  const float* lse_bh = lse + ((long long)b * H + h) * Lq;
  const float* dlt_bh = delta + ((long long)b * H + h) * Lq;
  load_rows_f32(q + qoff, C, q0, PT_FROWS, Lq, &qs[0][0], PT_D);
  load_rows_f32(dout + qoff, C, q0, PT_FROWS, Lq, &dos[0][0], PT_D);
  const int kend = key_end(ends, min(q0 + PT_FROWS - 1, Lq - 1), Lk);
  int kr[PT_FRPW];
  float lse_r[PT_FRPW], dlt_r[PT_FRPW], acc0[PT_FRPW], acc1[PT_FRPW];
#pragma unroll
  for (int i = 0; i < PT_FRPW; ++i) {
    const int qi = q0 + warp * PT_FRPW + i;
    kr[i] = key_end(ends, min(qi, Lq - 1), Lk);
    lse_r[i] = qi < Lq ? lse_bh[qi] : 0.f;
    dlt_r[i] = qi < Lq ? dlt_bh[qi] : 0.f;
    acc0[i] = acc1[i] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += PT_T) {
    __syncthreads();
    load_rows_f32(kb, C, k0, PT_T, Lk, &ks[0][0], PT_D + 1);
    load_rows_f32(vb, C, k0, PT_T, Lk, &vs[0][0], PT_D + 1);
    __syncthreads();

    float s0[PT_FRPW], s1[PT_FRPW], dp0[PT_FRPW], dp1[PT_FRPW];
#pragma unroll
    for (int i = 0; i < PT_FRPW; ++i) s0[i] = s1[i] = dp0[i] = dp1[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < PT_D; ++d) {
      const float ka = ks[lane][d], kc = ks[lane + 32][d];
      const float va = vs[lane][d], vc = vs[lane + 32][d];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float qv = qs[warp * PT_FRPW + i][d], gv = dos[warp * PT_FRPW + i][d];
        s0[i] = fmaf(qv, ka, s0[i]);
        s1[i] = fmaf(qv, kc, s1[i]);
        dp0[i] = fmaf(gv, va, dp0[i]);
        dp1[i] = fmaf(gv, vc, dp1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PT_FRPW; ++i) {
      const bool ok0 = k0 + lane < kr[i], ok1 = k0 + lane + 32 < kr[i];
      const float p0 = ok0 ? expf(s0[i] - lse_r[i]) : 0.f;
      const float p1 = ok1 ? expf(s1[i] - lse_r[i]) : 0.f;
      const float dlt = dlt_r[i];
      s0[i] = ok0 ? p0 * (dp0[i] - dlt) : 0.f;  // ds
      s1[i] = ok1 ? p1 * (dp1[i] - dlt) : 0.f;
    }
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float ka = ks[jj][lane], kc = ks[jj][lane + 32];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, s0[i], jj);
        acc0[i] = fmaf(dsj, ka, acc0[i]);
        acc1[i] = fmaf(dsj, kc, acc1[i]);
      }
    }
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float ka = ks[32 + jj][lane], kc = ks[32 + jj][lane + 32];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, s1[i], jj);
        acc0[i] = fmaf(dsj, ka, acc0[i]);
        acc1[i] = fmaf(dsj, kc, acc1[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PT_FRPW; ++i) {
    const int qi = q0 + warp * PT_FRPW + i;
    if (qi < Lq) {
      float* o = dq + qoff + (long long)qi * C;
      o[lane] = acc0[i];
      o[lane + 32] = acc1[i];
    }
  }
}

template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int H,
                      Ends ends) {
  __shared__ float ks[PT_FROWS][PT_D];
  __shared__ float vs[PT_FROWS][PT_D];
  __shared__ float qs[PT_T][PT_D + 1];
  __shared__ float dos[PT_T][PT_D + 1];
  __shared__ float lse_s[PT_T], dlt_s[PT_T];
  __shared__ int kend_s[PT_T];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * PT_FROWS;
  const int C = H * PT_D;
  const float* qb = q + (long long)b * Lq * C + h * PT_D;
  const float* dob = dout + (long long)b * Lq * C + h * PT_D;
  const long long koff = (long long)b * Lk * C + h * PT_D;
  const float* lse_bh = lse + ((long long)b * H + h) * Lq;
  const float* dlt_bh = delta + ((long long)b * H + h) * Lq;
  load_rows_f32(k + koff, C, k0, PT_FROWS, Lk, &ks[0][0], PT_D);
  load_rows_f32(v + koff, C, k0, PT_FROWS, Lk, &vs[0][0], PT_D);
  float dk0[PT_FRPW], dk1[PT_FRPW], dv0[PT_FRPW], dv1[PT_FRPW];
#pragma unroll
  for (int i = 0; i < PT_FRPW; ++i) dk0[i] = dk1[i] = dv0[i] = dv1[i] = 0.f;

  for (int q0 = query_begin(ends, k0) / PT_T * PT_T; q0 < Lq; q0 += PT_T) {
    __syncthreads();
    load_rows_f32(qb, C, q0, PT_T, Lq, &qs[0][0], PT_D + 1);
    load_rows_f32(dob, C, q0, PT_T, Lq, &dos[0][0], PT_D + 1);
    if (threadIdx.x < PT_T) {
      const int i = q0 + threadIdx.x;
      const bool ok = i < Lq;
      lse_s[threadIdx.x] = ok ? lse_bh[i] : 0.f;
      dlt_s[threadIdx.x] = ok ? dlt_bh[i] : 0.f;
      kend_s[threadIdx.x] = ok ? key_end(ends, i, Lk) : 0;
    }
    __syncthreads();

    float s0[PT_FRPW], s1[PT_FRPW], dp0[PT_FRPW], dp1[PT_FRPW];
#pragma unroll
    for (int i = 0; i < PT_FRPW; ++i) s0[i] = s1[i] = dp0[i] = dp1[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < PT_D; ++d) {
      const float qa = qs[lane][d], qc = qs[lane + 32][d];
      const float ga = dos[lane][d], gc = dos[lane + 32][d];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float kv = ks[warp * PT_FRPW + i][d], vv = vs[warp * PT_FRPW + i][d];
        s0[i] = fmaf(kv, qa, s0[i]);
        s1[i] = fmaf(kv, qc, s1[i]);
        dp0[i] = fmaf(vv, ga, dp0[i]);
        dp1[i] = fmaf(vv, gc, dp1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PT_FRPW; ++i) {
      const int kj = k0 + warp * PT_FRPW + i;
      const bool ok0 = kj < kend_s[lane], ok1 = kj < kend_s[lane + 32];
      s0[i] = ok0 ? expf(s0[i] - lse_s[lane]) : 0.f;  // p
      s1[i] = ok1 ? expf(s1[i] - lse_s[lane + 32]) : 0.f;
      float dlt = dlt_s[lane];
      dp0[i] = ok0 ? s0[i] * (dp0[i] - dlt) : 0.f;  // ds
      dlt = dlt_s[lane + 32];
      dp1[i] = ok1 ? s1[i] * (dp1[i] - dlt) : 0.f;
    }
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float qa = qs[jj][lane], qc = qs[jj][lane + 32];
      const float ga = dos[jj][lane], gc = dos[jj][lane + 32];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, s0[i], jj);
        const float dsj = __shfl_sync(0xffffffffu, dp0[i], jj);
        dv0[i] = fmaf(pj, ga, dv0[i]);
        dv1[i] = fmaf(pj, gc, dv1[i]);
        dk0[i] = fmaf(dsj, qa, dk0[i]);
        dk1[i] = fmaf(dsj, qc, dk1[i]);
      }
    }
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float qa = qs[32 + jj][lane], qc = qs[32 + jj][lane + 32];
      const float ga = dos[32 + jj][lane], gc = dos[32 + jj][lane + 32];
#pragma unroll
      for (int i = 0; i < PT_FRPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, s1[i], jj);
        const float dsj = __shfl_sync(0xffffffffu, dp1[i], jj);
        dv0[i] = fmaf(pj, ga, dv0[i]);
        dv1[i] = fmaf(pj, gc, dv1[i]);
        dk0[i] = fmaf(dsj, qa, dk0[i]);
        dk1[i] = fmaf(dsj, qc, dk1[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PT_FRPW; ++i) {
    const int kj = k0 + warp * PT_FRPW + i;
    if (kj < Lk) {
      dk[koff + (long long)kj * C + lane] = dk0[i];
      dk[koff + (long long)kj * C + lane + 32] = dk1[i];
      dv[koff + (long long)kj * C + lane] = dv0[i];
      dv[koff + (long long)kj * C + lane + 32] = dv1[i];
    }
  }
}

// ---------------------------------------------------------------------------
// C interface. Every tensor is contiguous: q, out, dout, dq (B, Lq, H * 64);
// k, v, dk, dv (B, Lk, H * 64); lse, delta (B, H, Lq) fp32. ``ends`` holds
// n_ends ascending scale ends (none: no mask). Returns cudaGetLastError().
// var_ptrain_* launch the kRow = 6 instantiation (row 6), var_flash_* the
// kRow = 5 one (row 5).

static int make_ends(const int* ends, int n_ends, Ends* out) {
  if (n_ends < 0 || n_ends > PT_MAX_ENDS || (n_ends > 0 && ends == nullptr)) return 1;
  out->n = n_ends;
  for (int i = 0; i < PT_MAX_ENDS; ++i) out->e[i] = i < n_ends ? ends[i] : 0;
  return 0;
}

template <int kRow>
static int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                      int Lq, int Lk, int H, int D, const int* ends, int n_ends, int dtype,
                      int device, void* stream) {
  Ends e;
  if (D != PT_D || B < 1 || Lq < 1 || Lk < 1 || H < 1 || make_ends(ends, n_ends, &e))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    const dim3 grid((unsigned)((Lq + PT_FROWS - 1) / PT_FROWS), (unsigned)H, (unsigned)B);
    ptrain_fwd_f32_kernel<kRow><<<grid, 128, 0, st>>>((const float*)q, (const float*)k,
                                                      (const float*)v, (float*)out, (float*)lse,
                                                      Lq, Lk, H, e);
  } else if (dtype == kBF16) {
    const dim3 grid((unsigned)((Lq + PT_T - 1) / PT_T), (unsigned)H, (unsigned)B);
    ptrain_fwd_mma_kernel<kRow><<<grid, 128, 0, st>>>((const bf16*)q, (const bf16*)k,
                                                      (const bf16*)v, (bf16*)out, (float*)lse,
                                                      Lq, Lk, H, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int kRow>
static int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                      int Lq, int Lk, int H, int D, const int* ends, int n_ends, int dtype,
                      int device, void* stream) {
  Ends e;
  if (D != PT_D || B < 1 || Lq < 1 || Lk < 1 || H < 1 || make_ends(ends, n_ends, &e))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ls = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == kF32) {
    const dim3 gq((unsigned)((Lq + PT_FROWS - 1) / PT_FROWS), (unsigned)H, (unsigned)B);
    ptrain_dq_f32_kernel<kRow><<<gq, 128, 0, st>>>((const float*)q, (const float*)k,
                                                   (const float*)v, (const float*)dout, ls, dl,
                                                   (float*)dq, Lq, Lk, H, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 gk((unsigned)((Lk + PT_FROWS - 1) / PT_FROWS), (unsigned)H, (unsigned)B);
    ptrain_dkv_f32_kernel<kRow><<<gk, 128, 0, st>>>((const float*)q, (const float*)k,
                                                    (const float*)v, (const float*)dout, ls, dl,
                                                    (float*)dk, (float*)dv, Lq, Lk, H, e);
  } else if (dtype == kBF16) {
    const dim3 gq((unsigned)((Lq + PT_T - 1) / PT_T), (unsigned)H, (unsigned)B);
    ptrain_dq_mma_kernel<kRow><<<gq, 128, 0, st>>>((const bf16*)q, (const bf16*)k,
                                                   (const bf16*)v, (const bf16*)dout, ls, dl,
                                                   (bf16*)dq, Lq, Lk, H, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 gk((unsigned)((Lk + PT_T - 1) / PT_T), (unsigned)H, (unsigned)B);
    ptrain_dkv_mma_kernel<kRow><<<gk, 128, 0, st>>>((const bf16*)q, (const bf16*)k,
                                                    (const bf16*)v, (const bf16*)dout, ls, dl,
                                                    (bf16*)dk, (bf16*)dv, Lq, Lk, H, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int var_ptrain_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Lq, int Lk, int H, int D, const int* ends, int n_ends,
                              int dtype, int device, void* stream) {
  return launch_fwd<6>(q, k, v, out, lse, B, Lq, Lk, H, D, ends, n_ends, dtype, device, stream);
}

extern "C" int var_ptrain_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, void* dk, void* dv,
                              int B, int Lq, int Lk, int H, int D, const int* ends, int n_ends,
                              int dtype, int device, void* stream) {
  return launch_bwd<6>(q, k, v, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H, D, ends, n_ends,
                       dtype, device, stream);
}

extern "C" int var_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int Lq, int Lk, int H, int D, const int* ends, int n_ends,
                             int dtype, int device, void* stream) {
  return launch_fwd<5>(q, k, v, out, lse, B, Lq, Lk, H, D, ends, n_ends, dtype, device, stream);
}

extern "C" int var_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, void* dk, void* dv,
                             int B, int Lq, int Lk, int H, int D, const int* ends, int n_ends,
                             int dtype, int device, void* stream) {
  return launch_bwd<5>(q, k, v, dout, lse, delta, dq, dk, dv, B, Lq, Lk, H, D, ends, n_ends,
                       dtype, device, stream);
}
