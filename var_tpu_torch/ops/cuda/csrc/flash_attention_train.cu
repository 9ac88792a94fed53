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
// recomputed, delta = sum_d do * o per (row, head) is computed in the
// backward's first launch from the bf16 (or fp32) out and do, then
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
// 93.9 GFLOP for its five products (95 us) against 359 MB (107 us). At
// 512px (batch 8, L = 2240, 65% of the pairs useful) and 1024px (batch 2,
// L = 9451) the tensor cores bound it: backward 268 GFLOP (271 us) at
// 512px. The backward below runs seven products per visible tile pair, not
// five (S and dP are computed once per pass, so that neither pass needs
// atomics): its tensor-core floor is 1.4x the bound, 133 us at 256px and
// 379 us at 512px.
//
// Design:
//  * the mask's structure bounds every loop: a query tile visits key tiles
//    only up to ends[level(its last query)], a key tile visits query tiles
//    only from the start of its first key's scale, so most pairs the mask
//    kills are never loaded;
//  * forward (bf16): one warpgroup per (64-query tile, head, batch), the
//    dQ kernel's grid, the last query tile of a (head, batch) first. Q
//    lands once by TMA; thread 0 streams the K and V tiles of [0, kend)
//    into a 2-stage K ring and a 3-stage V ring on mbarriers. S = Q K^T
//    (K-major) and O += P V (V through the transpose bit, P from the
//    accumulators rounded to bf16 as the register A operand) are wgmma
//    m64n64k16 with fp32 accumulators. The online softmax works in log2
//    units (one fma and one ex2 per logit), and runs on tile i while the
//    tensor cores still compute tile i-1's P V; O is rescaled once that
//    product is done. Shared with the dQ kernel: the tensor maps and
//    their zero fill past Lq and Lk, the swizzled tiles and descriptors,
//    the kend/kall bounds (the mask only on the diagonal or past Lk), the
//    one 128-thread barrier per tile before a stage is refilled, and the
//    broadcast warp index (below);
//  * backward (bf16), two passes, deterministic, no atomics: the dQ kernel
//    (one warpgroup per 64-query tile of one head) and then, on the same
//    stream, the dK/dV kernel (one warpgroup per 64-key tile; two
//    warpgroups of 64 keys sharing one ring measured slower, PERF.md). Each
//    loads its resident tiles (Q and dO, or K and V) once with TMA, and
//    thread 0 streams the other operand's 64-row tiles (K and V, or Q, dO
//    and the tile's 64 lse and delta values) into a 3-stage ring on
//    mbarriers. The tensor maps have L rows per batch, so rows past Lq or Lk
//    arrive as zeros. Tiles land 128-byte swizzled in their natural
//    row-major (row, d) layout and every product is wgmma m64n64k16 with
//    fp32 accumulators, reading them through descriptors: S = Q K^T and dP =
//    dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV) K-major; dQ += dS K,
//    dV += P^T dO and dK += dS^T Q take dS, P^T, dS^T from the accumulator
//    registers, rounded to bf16, as the A operand and K, dO, Q through the
//    transpose bit -- no element is transposed in shared memory. Within a
//    warpgroup, tile i's softmax-gradient arithmetic runs while the tensor
//    cores still compute tile i-1's dQ (or dK and dV) products; a stage is
//    refilled once every warp is past its last reader (one 128-thread
//    barrier per tile). Only tiles on the mask's diagonal or past Lq/Lk
//    test the mask per element; the rest run without a test. The dQ kernel
//    computes delta from out and do in its prologue while its first copies
//    fly and writes the lse and delta of its rows into a scratch the dK/dV
//    kernel's ring reads: no PyTorch pass, five fewer launches. The warp
//    index is broadcast with __shfl_sync so that ptxas sees every branch
//    around wgmma as warp-uniform (else it serialises them);
//  * fp32: the same passes on the CUDA cores, 16-row tiles, lanes over keys
//    (or queries) and over head dims, synchronous loads; delta in a small
//    kernel of its own before them.

#include "common.cuh"

using namespace vtt;

typedef __nv_bfloat16 bf16;

#define PT_D 64          // head dim served
#define PT_T 64          // rows per tile of the bf16 kernels, keys per tile everywhere
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
// bf16 kernels on Hopper (see the note at the top). Dynamic shared memory
// from a 1024-byte aligned base; every tile is 64 rows of one head's 64
// lanes (128 bytes), 128-byte swizzled, as TMA writes it and wgmma reads it.

#define BW_TILE (PT_T * PT_D * 2)  // bytes of one swizzled 64 x 64 bf16 tile
#define BW_KV_STAGES 3             // dQ: K+V tile pairs in the ring
#define BW_QD_STAGES 3             // dK/dV: Q+dO tile pairs (+ lse, delta) in the ring
#define BW_STAT (2 * PT_T * 4)     // bytes of a query tile's 64 lse and 64 delta values
#define BW_LOG2E 1.4426950408889634f
#define BW_LN2 0.6931471805599453f
// Q, dO, the K/V ring; + room to align the base, + the mbarriers
#define BW_DQ_SMEM ((2 + 2 * BW_KV_STAGES) * BW_TILE + 1024 + (1 + BW_KV_STAGES) * 8)
// K, V, the Q/dO ring, the lse/delta ring; + alignment, + mbarriers
#define BW_DKV_SMEM \
  ((2 + 2 * BW_QD_STAGES) * BW_TILE + BW_QD_STAGES * BW_STAT + 1024 + (1 + BW_QD_STAGES) * 8)
#define FW_KSTAGES 2  // forward: K tiles in their ring
#define FW_VSTAGES 3  // forward: V tiles in theirs
// forward: Q, the K ring, the V ring; + alignment, + the mbarriers
#define FW_SMEM \
  ((1 + FW_KSTAGES + FW_VSTAGES) * BW_TILE + 1024 + (1 + FW_KSTAGES + FW_VSTAGES) * 8)

// Query rows of the lse/delta scratch per (batch, head): Lq rounded up to
// whole 64-row tiles, so that every tile's 64 values are one aligned bulk copy.
__host__ __device__ __forceinline__ int stat_rows(int Lq) { return (Lq + PT_T - 1) / PT_T * PT_T; }

// Accumulator (fp32, the wgmma m64n64 layout) rounded to bf16 as the A
// operand of the next product: keys 16 kk .. 16 kk + 15 are the
// accumulator's n8 tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_frag(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Rows r and r + 8 of a warpgroup's 64 x 64 accumulator (row r = 16 warp +
// lane / 4) to a merged (L, C) bf16 matrix; rows at or past L are dropped.
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, int C, int r, int L,
                                          const float (&acc)[32]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * C + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r + 8) * C + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// bf16 forward: block = (64-query tile, head, batch), one warpgroup; warp
// w owns queries 16 w .. 16 w + 15. Thread 0 streams the K and V tiles of
// [0, kend) into their rings; the warpgroup computes S = Q K^T and O += P V
// over each of them with wgmma. The blocks of a (head, batch) start with
// the last query tile, whose key range is longest, so the short tiles fill
// the tail of the grid. (Two warpgroups sharing the rings over 128 queries,
// and one 3-stage K+V pair ring as in dQ, measured slower: PERF.md.)
template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                        float* __restrict__ lse, int Lq, int Lk, int H, Ends ends) {
  extern __shared__ uint8_t bw_smem[];
  const uint32_t base = (smem_u32(bw_smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wq = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform, as in dQ
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * PT_T;
  const int C = H * PT_D;
  const uint32_t sq = base, sk = base + BW_TILE;  // Q, then the K ring
  const uint32_t sv = sk + FW_KSTAGES * BW_TILE;    // the V ring
  const uint32_t q_full = sv + FW_VSTAGES * BW_TILE;  // Q landed
  const uint32_t kfull = q_full + 8;                  // + 8 s: K tile of stage s landed
  const uint32_t vfull = kfull + 8 * FW_KSTAGES;      // + 8 s: V tile of stage s landed
  // key tiles [0, kend) hold every key a query of the block sees; below
  // kall, every query of the block sees every key
  const int kend = key_end(ends, min(q0 + PT_T - 1, Lq - 1), Lk);
  const int kall = key_end(ends, q0, Lk);
  const int nkt = (kend + PT_T - 1) / PT_T;
  // thread 0 copies key tile t of K or V into its stage; rows >= Lk lie
  // outside the tensor maps and arrive as zeros
  auto load_k = [&](int t) {
    const int st = t % FW_KSTAGES;
    mbar_arrive_expect_tx(kfull + 8 * st, BW_TILE);
    tma_load_3d(sk + st * BW_TILE, &tm_k, kfull + 8 * st, h * PT_D, t * PT_T, b);
  };
  auto load_v = [&](int t) {
    const int st = t % FW_VSTAGES;
    mbar_arrive_expect_tx(vfull + 8 * st, BW_TILE);
    tma_load_3d(sv + st * BW_TILE, &tm_v, vfull + 8 * st, h * PT_D, t * PT_T, b);
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FW_KSTAGES + FW_VSTAGES; ++s) mbar_init(kfull + 8 * s, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(q_full, BW_TILE);  // rows >= Lq arrive as zeros
    tma_load_3d(sq, &tm_q, q_full, h * PT_D, q0, b);
    for (int t = 0; t < FW_KSTAGES && t < nkt; ++t) load_k(t);
    load_v(0);
  }
  __syncthreads();  // the barriers are initialised

  // this thread's rows ra and rb see keys [0, kend_a) and [0, kend_b)
  const int ra = q0 + wq * 16 + g, rb = ra + 8;
  const int kend_a = key_end(ends, min(ra, Lq - 1), Lk);
  const int kend_b = key_end(ends, min(rb, Lq - 1), Lk);
  // Q: A of S = Q K^T, K-major; 16 of d (32 bytes of the swizzled row) per step
  const uint64_t dsc_q = wgmma_desc_sw128(sq, 16, 1024);
  float o[32], s[32];
  uint32_t pa[4][4];  // P of the previous tile in bf16, the A operand of O += P V
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // running max of rows ra and rb in log2 units, this thread's share of
  // their sums, and the factor O takes before the next P V
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, alpha0 = 1.f, alpha1 = 1.f;

  // Online softmax of S (tile it) in place: s becomes p = 2^(s log2e - m)
  // in fp32 (one fma and one ex2 per logit). Only a tile that reaches past
  // kall (the block-causal diagonal, or a ragged last tile at Lk) is masked
  // per element, to -inf: a zero-filled key row past Lk has s = 0.
  auto softmax = [&](int it) {
    const int k0 = it * PT_T;
    if (k0 + PT_T > kall) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        if (col >= ((i & 2) ? kend_b : kend_a)) s[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key 0 is visible from every query, so m is finite after the first tile
    const float mn0 = fmaxf(m0, mx0 * BW_LOG2E), mn1 = fmaxf(m1, mx1 * BW_LOG2E);
    alpha0 = fast_exp2(m0 - mn0);  // 0 on the first tile (m = -inf)
    alpha1 = fast_exp2(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = fast_exp2(fmaf(s[i], BW_LOG2E, (i & 2) ? -mn1 : -mn0));
      s[i] = p;
      if (i & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * alpha0 + sum0;  // l sums the fp32 p, before P rounds to bf16
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
  };
  // O += P V over V tile t, once it has landed: B stored [key][d] = [k][n],
  // MN-major (the transpose bit); 16 keys (2048 bytes) per step
  auto issue_pv = [&](int t) {
    const int st = t % FW_VSTAGES;
    mbar_wait(vfull + 8 * st, (t / FW_VSTAGES) & 1);
    const uint64_t dsc_v = wgmma_desc_sw128(sv + st * BW_TILE, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs_tb(o, pa[kk], dsc_v + 128 * kk);
    wgmma_commit();
  };
  mbar_wait(q_full, 0);

  // Iteration it: S = Q K_it^T is issued once K_it has landed, then O +=
  // P_{it-1} V_{it-1}. When S is done, K_it's stage and V_{it-2}'s are free:
  // thread 0 refills them with K_{it+2} and V_{it+1}. The softmax of S runs
  // while the tensor cores still work on P V; O is rescaled once P V is done.
  for (int it = 0; it < nkt; ++it) {
    const int kst = it % FW_KSTAGES;
    mbar_wait(kfull + 8 * kst, (it / FW_KSTAGES) & 1);
    // K tile: B of S = Q K^T stored [key][d], K-major
    const uint64_t dsc_k = wgmma_desc_sw128(sk + kst * BW_TILE, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(s, dsc_q + 2 * kk, dsc_k + 2 * kk, kk > 0);
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
      if (it + FW_KSTAGES < nkt) load_k(it + FW_KSTAGES);
      if (it + 1 < nkt) load_v(it + 1);
    }
    softmax(it);
    wgmma_wait<0>();
    wgmma_fence_regs(o);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
    pack_frag(s, pa);
  }
  wgmma_fence();
  issue_pv(nkt - 1);
  wgmma_wait<0>();
  wgmma_fence_regs(o);

  // out = o / l_safe in bf16 (l_safe = 1 where l = 0), lse = m + log l_safe
  // in natural-log units, as the backward reads it
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float la = l0 > 0.f ? l0 : 1.f, lb = l1 > 0.f ? l1 : 1.f;
  const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? ib : ia;
  store_acc(out + (long long)b * Lq * C + h * PT_D, C, ra, Lq, o);
  if (tq == 0) {
    float* lse_bh = lse + ((long long)b * H + h) * Lq;
    if (ra < Lq) lse_bh[ra] = m0 * BW_LN2 + logf(la);
    if (rb < Lq) lse_bh[rb] = m1 * BW_LN2 + logf(lb);
  }
}

// dQ: block = (64-query tile, head, batch), one warpgroup; warp w owns
// queries 16 w .. 16 w + 15. Also writes the lse and delta of its 64 rows
// into ``stats`` (B, H, 2, stat_rows(Lq)) fp32 for the dK/dV kernel.
template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ out,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ stats, bf16* __restrict__ dq, int Lq, int Lk, int H,
                       Ends ends) {
  extern __shared__ uint8_t bw_smem[];
  __shared__ float dlt_s[PT_T];
  const uint32_t base = (smem_u32(bw_smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index, broadcast from lane 0 so that the compiler sees it (and
  // every branch on it) as warp-uniform; else ptxas serialises the wgmma
  const int wq = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * PT_T;
  const int C = H * PT_D, Lp = stat_rows(Lq);
  const uint32_t sq = base, sdo = base + BW_TILE, ring = base + 2 * BW_TILE;
  const uint32_t res_full = ring + 2 * BW_KV_STAGES * BW_TILE;  // Q and dO landed
  const uint32_t kv_full = res_full + 8;  // + 8 s: the K and V tiles of stage s landed
  // key tiles [0, kend) hold every key any query of the block sees; below
  // kall, every query of the block sees every key
  const int kend = key_end(ends, min(q0 + PT_T - 1, Lq - 1), Lk);
  const int kall = key_end(ends, q0, Lk);
  const int ntiles = (kend + PT_T - 1) / PT_T;
  // thread 0 copies key tile t of K and V into stage t % BW_KV_STAGES;
  // rows >= Lk lie outside the tensor maps and arrive as zeros
  auto load_kv = [&](int t) {
    const int st = t % BW_KV_STAGES;
    const uint32_t dst = ring + 2 * st * BW_TILE, bar = kv_full + 8 * st;
    mbar_arrive_expect_tx(bar, 2 * BW_TILE);
    tma_load_3d(dst, &tm_k, bar, h * PT_D, t * PT_T, b);
    tma_load_3d(dst + BW_TILE, &tm_v, bar, h * PT_D, t * PT_T, b);
  };
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < BW_KV_STAGES; ++s) mbar_init(kv_full + 8 * s, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(res_full, 2 * BW_TILE);
    tma_load_3d(sq, &tm_q, res_full, h * PT_D, q0, b);
    tma_load_3d(sdo, &tm_do, res_full, h * PT_D, q0, b);
    for (int t = 0; t < BW_KV_STAGES && t < ntiles; ++t) load_kv(t);
  }

  // delta = sum_d do * out in fp32 from the bf16 tensors, while the copies
  // fly: 16-byte loads, 8 lanes per row, each warp its own 16 rows; the lse
  // and delta of every row of the tile (0 past Lq) go to the scratch
  {
    const int sub = lane >> 3, c = lane & 7;
    const long long off = (long long)b * Lq * C + h * PT_D + c * 8;
    const float* lse_bh = lse + ((long long)b * H + h) * Lq;
    float* st_bh = stats + ((long long)b * H + h) * 2 * Lp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wq * 16 + i * 4 + sub, qi = q0 + r;
      float dsum = 0.f;
      if (qi < Lq) {
        const uint4 o4 = *reinterpret_cast<const uint4*>(out + off + (long long)qi * C);
        const uint4 d4 = *reinterpret_cast<const uint4*>(dout + off + (long long)qi * C);
        const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&o4);
        const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fo = __bfloat1622float2(po[e]), fd = __bfloat1622float2(pd[e]);
          dsum = fmaf(fd.x, fo.x, dsum);
          dsum = fmaf(fd.y, fo.y, dsum);
        }
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 4);
      if (c == 0) {
        dlt_s[r] = dsum;
        st_bh[q0 + r] = qi < Lq ? lse_bh[qi] : 0.f;
        st_bh[Lp + q0 + r] = dsum;
      }
    }
  }
  __syncthreads();  // the barriers are initialised, delta is in dlt_s

  // this thread's rows ra and rb: -lse in log2 units, delta, visible keys
  const int ra = q0 + wq * 16 + g, rb = ra + 8;
  const float* lse_bh = lse + ((long long)b * H + h) * Lq;
  const float nla = ra < Lq ? -lse_bh[ra] * BW_LOG2E : 0.f;
  const float nlb = rb < Lq ? -lse_bh[rb] * BW_LOG2E : 0.f;
  const float dla = dlt_s[wq * 16 + g], dlb = dlt_s[wq * 16 + g + 8];
  const int kend_a = key_end(ends, min(ra, Lq - 1), Lk);
  const int kend_b = key_end(ends, min(rb, Lq - 1), Lk);

  // Q and dO: A of S = Q K^T and dP = dO V^T, K-major; 16 of d per step
  const uint64_t dsc_q = wgmma_desc_sw128(sq, 16, 1024);
  const uint64_t dsc_do = wgmma_desc_sw128(sdo, 16, 1024);
  float acc[32], s[32], dp[32];
  uint32_t dsa[4][4];  // dS of the previous tile in bf16, the A operand of dQ += dS K
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(res_full, 0);

  // dQ += dS K over key tile t: B = K stored [key][d] = [k][n], MN-major
  // (the transpose bit); 16 keys (2048 bytes) per step
  auto issue_dq = [&](int t) {
    const uint64_t dsc_kt =
        wgmma_desc_sw128(ring + 2 * (t % BW_KV_STAGES) * BW_TILE, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs_tb(acc, dsa[kk], dsc_kt + 128 * kk);
    wgmma_commit();
  };

  // Iteration it: S and dP of tile it are issued once it has landed, then
  // dQ += dS_{it-1} K_{it-1}; dS of tile it is computed while the tensor
  // cores still run that product. When it is done, the stage of tile it-1
  // is free and thread 0 refills it with tile it-1+BW_KV_STAGES.
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % BW_KV_STAGES;
    mbar_wait(kv_full + 8 * st, (it / BW_KV_STAGES) & 1);
    const uint32_t sk = ring + 2 * st * BW_TILE;
    const uint64_t dsc_k = wgmma_desc_sw128(sk, 16, 1024);
    const uint64_t dsc_v = wgmma_desc_sw128(sk + BW_TILE, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(s, dsc_q + 2 * kk, dsc_k + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(dp, dsc_do + 2 * kk, dsc_v + 2 * kk, kk > 0);
    wgmma_commit();
    if (it > 0) {
      issue_dq(it - 1);
      wgmma_wait<1>();  // S and dP are done; dQ may still run
    } else {
      wgmma_wait<0>();
    }
    wgmma_fence_regs(s);
    wgmma_fence_regs(dp);
    // ds = p (dp - delta), p = exp(s - lse); the mask only on tiles that
    // reach past kall (the diagonal of the block-causal mask, or Lk)
    const int k0 = it * PT_T;
    if (k0 + PT_T <= kall) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool lo = (i & 2) == 0;
        const float p = fast_exp2(fmaf(s[i], BW_LOG2E, lo ? nla : nlb));
        s[i] = p * (dp[i] - (lo ? dla : dlb));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool lo = (i & 2) == 0;
        const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        const float p = fast_exp2(fmaf(s[i], BW_LOG2E, lo ? nla : nlb));
        s[i] = col < (lo ? kend_a : kend_b) ? p * (dp[i] - (lo ? dla : dlb)) : 0.f;
      }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    named_barrier(1, 128);  // every warp is past K_{it-1}
    if (tid == 0 && it > 0 && it - 1 + BW_KV_STAGES < ntiles) load_kv(it - 1 + BW_KV_STAGES);
    pack_frag(s, dsa);
  }
  wgmma_fence();
  issue_dq(ntiles - 1);
  wgmma_wait<0>();
  wgmma_fence_regs(acc);
  store_acc(dq + (long long)b * Lq * C + h * PT_D, C, ra, Lq, acc);
}

// dK/dV's gradients of one tile in place: s (S^T) becomes p = exp(s - lse)
// and dp (dP^T) becomes ds = p (dp - delta), column (query) q0 + 8 j + 2 t +
// (i & 1) for s[i], i = 4 j + e, t = lane % 4; lse and delta from the stage
// at ``sl`` (this thread's first column), one pair of 8-byte reads per 4
// values. kMasked: zero where the key row (qbeg_a for e < 2, else qbeg_b)
// is not seen from the column, or the column is at or past Lq.
template <bool kMasked>
__device__ __forceinline__ void dkv_tile_grads(float (&s)[32], float (&dp)[32], uint32_t sl,
                                               int q0, int qbeg_a, int qbeg_b, int Lq) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float l0, l1, d0, d1;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(l0), "=f"(l1) : "r"(sl + 32 * j));
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(d0), "=f"(d1)
                 : "r"(sl + PT_T * 4 + 32 * j));
    l0 *= -BW_LOG2E;
    l1 *= -BW_LOG2E;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float p = fast_exp2(fmaf(s[i], BW_LOG2E, (e & 1) ? l1 : l0));
      const float ds = p * (dp[i] - ((e & 1) ? d1 : d0));
      if (kMasked) {
        const int col = q0 + 8 * j + 2 * t + (e & 1);
        const bool ok = col >= (e < 2 ? qbeg_a : qbeg_b) && col < Lq;
        s[i] = ok ? p : 0.f;
        dp[i] = ok ? ds : 0.f;
      } else {
        s[i] = p;
        dp[i] = ds;
      }
    }
  }
}

// dK/dV: block = (64 keys, head, batch), one warpgroup; warp w owns keys
// 16 w .. 16 w + 15. The products run transposed (S^T = K Q^T, dP^T = V
// dO^T), so P^T and dS^T come out of the accumulators in the A-operand
// layout of dV += P^T dO and dK += dS^T Q.
template <int kRow>
__global__ void __launch_bounds__(128)
ptrain_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ stats, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int Lq, int Lk, int H, Ends ends) {
  extern __shared__ uint8_t bw_smem[];
  const uint32_t base = (smem_u32(bw_smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform, as in dQ
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * PT_T;  // the block's keys
  const int C = H * PT_D, Lp = stat_rows(Lq);
  const uint32_t sk = base, sv = base + BW_TILE;
  const uint32_t ring = base + 2 * BW_TILE;                  // stage s: Q, then dO
  const uint32_t sstat = ring + 2 * BW_QD_STAGES * BW_TILE;  // stage s: 64 lse, 64 delta
  const uint32_t res_full = sstat + BW_QD_STAGES * BW_STAT;  // K and V landed
  const uint32_t qd_full = res_full + 8;  // + 8 s: the tiles of stage s landed
  const float* st_bh = stats + ((long long)b * H + h) * 2 * Lp;
  // query tiles from qb0 on hold every query that sees a key of the block;
  // every key of the block is seen from qall on
  const int qb0 = query_begin(ends, min(k0, Lk - 1)) / PT_T * PT_T;
  const int qall = query_begin(ends, min(k0 + PT_T - 1, Lk - 1));
  const int ntiles = (Lq - qb0 + PT_T - 1) / PT_T;
  // thread 0 copies query tile t of Q and dO (rows >= Lq arrive as zeros)
  // and its lse and delta into stage t % BW_QD_STAGES
  auto load_qd = [&](int t) {
    const int st = t % BW_QD_STAGES, q0 = qb0 + t * PT_T;
    const uint32_t dst = ring + 2 * st * BW_TILE, bar = qd_full + 8 * st;
    mbar_arrive_expect_tx(bar, 2 * BW_TILE + BW_STAT);
    tma_load_3d(dst, &tm_q, bar, h * PT_D, q0, b);
    tma_load_3d(dst + BW_TILE, &tm_do, bar, h * PT_D, q0, b);
    bulk_load(sstat + st * BW_STAT, st_bh + q0, PT_T * 4, bar);
    bulk_load(sstat + st * BW_STAT + PT_T * 4, st_bh + Lp + q0, PT_T * 4, bar);
  };
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < BW_QD_STAGES; ++s) mbar_init(qd_full + 8 * s, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(res_full, 2 * BW_TILE);
    tma_load_3d(sk, &tm_k, res_full, h * PT_D, k0, b);
    tma_load_3d(sv, &tm_v, res_full, h * PT_D, k0, b);
    for (int t = 0; t < BW_QD_STAGES && t < ntiles; ++t) load_qd(t);
  }
  __syncthreads();  // the barriers are initialised

  // this thread's keys ra and rb are seen from queries qbeg_a and qbeg_b on
  const int ra = k0 + warp * 16 + g, rb = ra + 8;
  const int qbeg_a = query_begin(ends, min(ra, Lk - 1));
  const int qbeg_b = query_begin(ends, min(rb, Lk - 1));
  // K and V: A of S^T = K Q^T and dP^T = V dO^T, K-major
  const uint64_t dsc_k = wgmma_desc_sw128(sk, 16, 1024);
  const uint64_t dsc_v = wgmma_desc_sw128(sv, 16, 1024);
  float dk_acc[32], dv_acc[32], s[32], dp[32];
  uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T of the previous tile in bf16
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(res_full, 0);

  // dV += P^T dO and dK += dS^T Q over query tile t: B = dO or Q stored
  // [query][d] = [k][n], MN-major (the transpose bit); 16 queries per step
  auto issue_dkv = [&](int t) {
    const uint32_t sq = ring + 2 * (t % BW_QD_STAGES) * BW_TILE;
    const uint64_t dsc_qt = wgmma_desc_sw128(sq, 1024, 1024);
    const uint64_t dsc_dot = wgmma_desc_sw128(sq + BW_TILE, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs_tb(dv_acc, pa[kk], dsc_dot + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs_tb(dk_acc, dsa[kk], dsc_qt + 128 * kk);
    wgmma_commit();
  };

  // Iteration it, as in dQ: S^T and dP^T of tile it, then the dK/dV
  // products of tile it-1; P^T and dS^T of tile it meanwhile; then the
  // stage of tile it-1 is refilled. Every warpgroup runs every tile of the
  // block (one whose queries see none of its keys comes out masked to 0):
  // wgmma groups that depend on the path make ptxas serialise them.
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % BW_QD_STAGES, q0 = qb0 + it * PT_T;
    mbar_wait(qd_full + 8 * st, (it / BW_QD_STAGES) & 1);
    const uint32_t sq = ring + 2 * st * BW_TILE;
    const uint64_t dsc_q = wgmma_desc_sw128(sq, 16, 1024);
    const uint64_t dsc_do = wgmma_desc_sw128(sq + BW_TILE, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(s, dsc_k + 2 * kk, dsc_q + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(dp, dsc_v + 2 * kk, dsc_do + 2 * kk, kk > 0);
    wgmma_commit();
    if (it > 0) {
      issue_dkv(it - 1);
      wgmma_wait<1>();  // S^T and dP^T are done; dK/dV may still run
    } else {
      wgmma_wait<0>();
    }
    wgmma_fence_regs(s);
    wgmma_fence_regs(dp);
    // p and ds; the mask only on tiles before qall (the diagonal of the
    // block-causal mask) or past Lq
    const uint32_t sl = sstat + st * BW_STAT + (2 * tq) * 4;
    if (q0 >= qall && q0 + PT_T <= Lq)
      dkv_tile_grads<false>(s, dp, sl, q0, qbeg_a, qbeg_b, Lq);
    else
      dkv_tile_grads<true>(s, dp, sl, q0, qbeg_a, qbeg_b, Lq);
    wgmma_wait<0>();
    wgmma_fence_regs(dk_acc);
    wgmma_fence_regs(dv_acc);
    named_barrier(1, 128);  // every warp is past Q_{it-1} and dO_{it-1}
    if (tid == 0 && it > 0 && it - 1 + BW_QD_STAGES < ntiles) load_qd(it - 1 + BW_QD_STAGES);
    pack_frag(s, pa);
    pack_frag(dp, dsa);
  }
  wgmma_fence();
  issue_dkv(ntiles - 1);
  wgmma_wait<0>();
  wgmma_fence_regs(dk_acc);
  wgmma_fence_regs(dv_acc);
  const long long koff = (long long)b * Lk * C + h * PT_D;
  store_acc(dk + koff, C, ra, Lk, dk_acc);
  store_acc(dv + koff, C, ra, Lk, dv_acc);
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

// fp32 delta = sum_d do * out per (row, head) into (B, H, Lq): a warp per
// row, four rows per block (the fp32 dQ and dK/dV kernels read it).
__global__ void __launch_bounds__(128)
train_delta_f32_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                       float* __restrict__ delta, int Lq, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, i = blockIdx.x * 4 + warp;
  if (i >= Lq) return;
  const long long off = ((long long)b * Lq + i) * H * PT_D + h * PT_D;
  const float s = warp_sum(fmaf(dout[off + lane], out[off + lane],
                                dout[off + lane + 32] * out[off + lane + 32]));
  if (lane == 0) delta[((long long)b * H + h) * Lq + i] = s;
}

// ---------------------------------------------------------------------------
// C interface. Every tensor is contiguous: q, out, dout, dq (B, Lq, H * 64);
// k, v, dk, dv (B, Lk, H * 64); lse (B, H, Lq) fp32. The backward's
// ``scratch`` holds 2 B H stat_rows(Lq) fp32 (the wrapper allocates it):
// the bf16 path's lse and delta per (batch, head), (B, H, 2, stat_rows(Lq));
// the fp32 path's delta, (B, H, Lq). ``ends`` holds n_ends ascending scale
// ends (none: no mask). Returns cudaGetLastError(). var_ptrain_* launch the
// kRow = 6 instantiation (row 6), var_flash_* the kRow = 5 one (row 5).

static int make_ends(const int* ends, int n_ends, Ends* out) {
  if (n_ends < 0 || n_ends > PT_MAX_ENDS || (n_ends > 0 && ends == nullptr)) return 1;
  out->n = n_ends;
  for (int i = 0; i < PT_MAX_ENDS; ++i) out->e[i] = i < n_ends ? ends[i] : 0;
  return 0;
}

// The shared-memory attribute of one kernel, set once per device.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, bool* ready, int device) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready[device] = true;
  return err;
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
    // merged (B, L, H * 64) tensors, rows of C elements; the wrapper checks
    // 16-byte alignment (TMA needs it)
    const long long C = (long long)H * PT_D;
    CUtensorMap tm_q, tm_k, tm_v;
    if ((err = tile_tensor_map(&tm_q, q, Lq * C, C, B, Lq, H)) != cudaSuccess ||
        (err = tile_tensor_map(&tm_k, k, Lk * C, C, B, Lk, H)) != cudaSuccess ||
        (err = tile_tensor_map(&tm_v, v, Lk * C, C, B, Lk, H)) != cudaSuccess)
      return (int)err;
    static bool ready[64] = {};
    if ((err = allow_smem(ptrain_fwd_wgmma_kernel<kRow>, FW_SMEM, ready, device)) != cudaSuccess)
      return (int)err;
    const dim3 grid((unsigned)((Lq + PT_T - 1) / PT_T), (unsigned)H, (unsigned)B);
    ptrain_fwd_wgmma_kernel<kRow><<<grid, 128, FW_SMEM, st>>>(tm_q, tm_k, tm_v, (bf16*)out,
                                                             (float*)lse, Lq, Lk, H, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int kRow>
static int launch_bwd(const void* q, const void* k, const void* v, const void* out,
                      const void* dout, const void* lse, void* scratch, void* dq, void* dk,
                      void* dv, int B, int Lq, int Lk, int H, int D, const int* ends, int n_ends,
                      int dtype, int device, void* stream) {
  Ends e;
  if (D != PT_D || B < 1 || Lq < 1 || Lk < 1 || H < 1 || make_ends(ends, n_ends, &e))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ls = (const float*)lse;
  if (dtype == kF32) {
    float* dl = (float*)scratch;
    const dim3 gd((unsigned)((Lq + 3) / 4), (unsigned)H, (unsigned)B);
    train_delta_f32_kernel<<<gd, 128, 0, st>>>((const float*)out, (const float*)dout, dl, Lq, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
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
    // merged (B, L, H * 64) tensors, rows of C elements; the wrapper checks
    // 16-byte alignment (TMA needs it)
    const long long C = (long long)H * PT_D;
    CUtensorMap tm_q, tm_do, tm_k, tm_v;
    if ((err = tile_tensor_map(&tm_q, q, Lq * C, C, B, Lq, H)) != cudaSuccess ||
        (err = tile_tensor_map(&tm_do, dout, Lq * C, C, B, Lq, H)) != cudaSuccess ||
        (err = tile_tensor_map(&tm_k, k, Lk * C, C, B, Lk, H)) != cudaSuccess ||
        (err = tile_tensor_map(&tm_v, v, Lk * C, C, B, Lk, H)) != cudaSuccess)
      return (int)err;
    static bool ready_dq[64] = {}, ready_dkv[64] = {};
    if ((err = allow_smem(ptrain_dq_wgmma_kernel<kRow>, BW_DQ_SMEM, ready_dq, device)) !=
            cudaSuccess ||
        (err = allow_smem(ptrain_dkv_wgmma_kernel<kRow>, BW_DKV_SMEM, ready_dkv, device)) !=
            cudaSuccess)
      return (int)err;
    float* stats = (float*)scratch;
    const dim3 gq((unsigned)((Lq + PT_T - 1) / PT_T), (unsigned)H, (unsigned)B);
    ptrain_dq_wgmma_kernel<kRow><<<gq, 128, BW_DQ_SMEM, st>>>(
        tm_q, tm_do, tm_k, tm_v, (const bf16*)out, (const bf16*)dout, ls, stats, (bf16*)dq, Lq,
        Lk, H, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // after dQ on the same stream: it reads the lse and delta dQ wrote
    const dim3 gk((unsigned)((Lk + PT_T - 1) / PT_T), (unsigned)H, (unsigned)B);
    ptrain_dkv_wgmma_kernel<kRow><<<gk, 128, BW_DKV_SMEM, st>>>(
        tm_q, tm_do, tm_k, tm_v, stats, (bf16*)dk, (bf16*)dv, Lq, Lk, H, e);
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

extern "C" int var_ptrain_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* lse, void* scratch, void* dq, void* dk,
                              void* dv, int B, int Lq, int Lk, int H, int D, const int* ends,
                              int n_ends, int dtype, int device, void* stream) {
  return launch_bwd<6>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, Lq, Lk, H, D, ends,
                       n_ends, dtype, device, stream);
}

extern "C" int var_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int Lq, int Lk, int H, int D, const int* ends, int n_ends,
                             int dtype, int device, void* stream) {
  return launch_fwd<5>(q, k, v, out, lse, B, Lq, Lk, H, D, ends, n_ends, dtype, device, stream);
}

extern "C" int var_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const void* lse, void* scratch, void* dq, void* dk,
                             void* dv, int B, int Lq, int Lk, int H, int D, const int* ends,
                             int n_ends, int dtype, int device, void* stream) {
  return launch_bwd<5>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, Lq, Lk, H, D, ends,
                       n_ends, dtype, device, stream);
}
