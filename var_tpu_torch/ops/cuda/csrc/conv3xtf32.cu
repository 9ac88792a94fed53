// Float32-accurate convolution on the tensor cores (3xTF32): every
// convolution of the frozen VQVAE encoder and its quant_conv in float32
// inference, over channels-last (NHWC) activations.
//
//   y[b, oy, ox, n] = (res[b, oy, ox, n] +) (bias[n] + sum_{dy, dx, c}
//                      x[b, s oy + dy - pt, s ox + dx - pl, c] w[n, dy, dx, c])
//
// with x read as zero outside the image (the padding). Replaces no TPU
// kernel: the JAX package leaves its convolutions to XLA, which computes a
// float32 product at Precision.HIGHEST in several bf16 passes on the MXU.
// PyTorch's float32 convolution with TF32 off runs cuDNN's SIMT implicit
// GEMM (sm80_xmma_fprop_implicit_gemm_f32f32) or its FFT plan, which cannot
// use the tensor cores at all.
//
// Precision. Each float32 operand v is split exactly into hi = tf32(v) and
// lo = tf32(v - hi) (cvt.rna: round to nearest, ties away), and a product is
// lo_a hi_b + hi_a lo_b + hi_a hi_b, accumulated in float32, the small terms
// first. The term left out, lo_a lo_b, is about 2^-22 of the product, below
// float32's own rounding of the sum (one-pass TF32 keeps 2^-11).
//
// Bound on the H100: the tensor cores. Three TF32 products a term run at
// 495 / 3 = 165 TFLOP/s; the encoder's level-0 convolutions read each input
// byte from device memory about once (the nine taps' re-reads hit L2).
//
// Design: an implicit GEMM, M = B Ho Wo output pixels, N = Cout, K = kh kw
// Cin in (tap, channel) order, one persistent block a SM walking tiles of
// 128 pixels x BN channels (BN 160: N = 160, 320, 640 and 1920 are 1, 2, 4
// and 12 tiles; BN 32 for conv_out and quant_conv). A tile is box_h rows of
// box_w pixels (box_w = min(128, Wo rounded up to a power of two)); pixels
// past the image are computed on zeros and not stored.
//   * Warpgroup 0, one thread: the producer. For each k-block (one tap, 32
//     input channels) it fills a stage of a 4-stage ring with TMA: the
//     activations as one box of the 4-D tensor (C, W, H, B) at the tap's
//     offset -- the element strides give the downsample's stride 2, and
//     TMA's zero fill outside the tensor gives the padding, the
//     downsample's asymmetric (0, 1, 0, 1) included -- and the weights' hi
//     and lo tiles (BN x 32, K-major, split once a call by the wrapper).
//     All three 128-byte swizzled.
//   * Warpgroups 1 and 2: 64 pixels each. Per k-block a thread reads its
//     A fragment for four k8 steps from the swizzled tile (conflict-free),
//     splits it into hi and lo in registers, and launches 3 x 4
//     wgmma.m64nBNk8 tf32 with A from registers and B from shared memory
//     into a fresh partial sum (BN / 2 registers). It then waits for them,
//     frees the stage and adds the partial into its float32 accumulator
//     (BN / 2 more) with rounding to nearest; the other warpgroup's
//     products keep the tensor cores busy meanwhile. The tensor cores do
//     not round their running sum to nearest: carried through all of K
//     there, the encoder's sums drifted 2-10 times further from float64
//     than cuDNN's float32 ones; a k-block's partial is a fraction of the
//     whole, and the sums land at 0.2-1.8 times cuDNN's error. The
//     consumers take 232 registers each, the producer 40 (setmaxnreg).
//   * Epilogue: bias, then the residual (the ResnetBlock's shortcut, the
//     attention block's input) added as PyTorch's x + h does, float2 stores
//     of NHWC float32. The producer is already loading the next tile.
// No split-K and no atomics: every output's sum has one fixed order, so
// launches and graph replays give the same bits.

#include "common.cuh"

using namespace vtt;

namespace {

constexpr int kBM = 128;               // output pixels a tile
constexpr int kBK = 32;                // input channels a k-block: one 128-byte row
constexpr int kStages = 4;
constexpr int kThreads = 384;          // a producer warpgroup and two consumers
constexpr int kATile = kBM * kBK * 4;  // bytes of the activation tile

template <int BN> struct Tiles {
  static constexpr int kBTile = BN * kBK * 4;           // bytes of one weight tile
  static constexpr int kStage = kATile + 2 * kBTile;    // activations, weights hi, lo
  static constexpr int kSmem = kStages * kStage + 1024 + 2 * kStages * 8;
};

struct Geometry {
  int ho, wo, cout;           // the output
  int stride, pad_t, pad_l;   // of the input
  int kw, cblocks, nkb;       // taps a row, 32-channel blocks a tap, k-blocks
  int box_w, box_h, tiles_x, tiles_y, n_tiles, total;
};

struct Tile {
  int b, oy0, ox0, n0;
};

template <int BN>
__device__ __forceinline__ Tile tile_of(const Geometry& g, int t) {
  const int nt = t % g.n_tiles;
  int m = t / g.n_tiles;
  const int tx = m % g.tiles_x;
  m /= g.tiles_x;
  const int ty = m % g.tiles_y;
  return {m / g.tiles_y, ty * g.box_h, tx * g.box_w, nt * BN};
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

template <int R> __device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x BN, float32) = A (64 x 8) B (8 x BN) (+ D if ``accumulate``), tf32:
// A from registers -- per warp its 16 rows as a[0] (row g, column t), a[1]
// (row g + 8, column t), a[2] and a[3] (columns t + 4) -- and B from shared
// memory, K-major. The accumulator: d[4j + e] is row 16 w + g + 8 (e / 2),
// column 8j + 2t + e % 2 (w = warp % 4, g = lane / 4, t = lane % 4).
template <int BN> struct Mma;

template <> struct Mma<160> {
  static __device__ __forceinline__ void run(float (&d)[80], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <> struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

// A consumer warpgroup (warps 4-7 or 8-11): 64 rows of every tile of this
// block. The tensor cores' sum of a k-block (12 products into ``part``) is
// added to the float32 accumulator ``acc`` in registers, rounded to nearest
// (see the note at the top).
template <int BN>
__device__ __forceinline__ void consume(const Geometry& g, uint32_t base, uint32_t full,
                                        uint32_t empty, const float* __restrict__ bias,
                                        const float* __restrict__ res, float* __restrict__ y,
                                        int warp, int lane) {
  using T = Tiles<BN>;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = (warp - 4) * 16 + gq;  // warps 4-7 rows 0-63, warps 8-11 rows 64-127
  constexpr int kAcc = BN / 2;
  float acc[kAcc], part[kAcc];
  int it = 0;
  for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
    const Tile tl = tile_of<BN>(g, t);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < g.nkb; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t sa = base + s * T::kStage;
      const uint32_t sbh = sa + kATile, sbl = sbh + T::kBTile;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float v[4];
        v[0] = lds_f32(sa + sw128(r0, 2 * kk) + 4 * tq);
        v[1] = lds_f32(sa + sw128(r0 + 8, 2 * kk) + 4 * tq);
        v[2] = lds_f32(sa + sw128(r0, 2 * kk + 1) + 4 * tq);
        v[3] = lds_f32(sa + sw128(r0 + 8, 2 * kk + 1) + 4 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[kk][e] = tf32_rna(v[e]);
          alo[kk][e] = tf32_rna(v[e] - __uint_as_float(ahi[kk][e]));  // exact difference
        }
      }
      // B tiles: BN rows of 32 floats, K-major, 128-byte swizzled; a k8
      // step is 32 bytes along the row
      const uint64_t dh = wgmma_desc_sw128(sbh, 16, 1024), dl = wgmma_desc_sw128(sbl, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Mma<BN>::run(part, alo[kk], dh + 2 * kk, kk > 0);
        Mma<BN>::run(part, ahi[kk], dl + 2 * kk, 1);
        Mma<BN>::run(part, ahi[kk], dh + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int oy = tl.oy0 + r / g.box_w, ox = tl.ox0 + r % g.box_w;
      if (oy < g.ho && ox < g.wo) {
        const long long m = ((long long)tl.b * g.ho + oy) * g.wo + ox;
        float* yr = y + m * g.cout + tl.n0;
        const float* rr = res != nullptr ? res + m * g.cout + tl.n0 : nullptr;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          const float2 bb = *reinterpret_cast<const float2*>(bias + tl.n0 + col);
          float v0 = acc[4 * j + 2 * h] + bb.x, v1 = acc[4 * j + 2 * h + 1] + bb.y;
          if (rr != nullptr) {
            const float2 q = *reinterpret_cast<const float2*>(rr + col);
            v0 = q.x + v0;
            v1 = q.y + v1;
          }
          *reinterpret_cast<float2*>(yr + col) = make_float2(v0, v1);
        }
      }
    }
  }
}

// Dynamic shared memory, from a 1024-byte aligned base: kStages stages of
// (activation tile, weight hi tile, weight lo tile), then the full and the
// empty mbarrier of each stage.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3xtf32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_whi,
                        const __grid_constant__ CUtensorMap tm_wlo,
                        const float* __restrict__ bias, const float* __restrict__ res,
                        float* __restrict__ y, const Geometry g) {
  using T = Tiles<BN>;
  extern __shared__ uint8_t conv_smem[];
  const uint32_t base = (smem_u32(conv_smem) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * T::kStage;  // + 8 s: stage s landed
  const uint32_t empty = full + 8 * kStages;         // + 8 s: stage s read by all 8 warps
  const int tid = threadIdx.x, lane = tid & 31;
  // broadcast from lane 0 so that every branch on it is warp-uniform (a
  // branch ptxas cannot prove uniform around wgmma serialises it)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread; the warpgroup gives its registers away
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
        const Tile tl = tile_of<BN>(g, t);
        const int xi0 = tl.ox0 * g.stride - g.pad_l, yi0 = tl.oy0 * g.stride - g.pad_t;
        for (int kb = 0; kb < g.nkb; ++kb, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const int tap = kb / g.cblocks, cb = kb - tap * g.cblocks;
          const int dy = tap / g.kw, dx = tap - dy * g.kw;
          const uint32_t sa = base + s * T::kStage, bar = full + 8 * s;
          mbar_arrive_expect_tx(bar, T::kStage);
          tma_load_4d(sa, &tm_x, bar, cb * kBK, xi0 + dx, yi0 + dy, tl.b);
          tma_load_2d(sa + kATile, &tm_whi, bar, kb * kBK, tl.n0);
          tma_load_2d(sa + kATile + T::kBTile, &tm_wlo, bar, kb * kBK, tl.n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<BN>(g, base, full, empty, bias, res, y, warp, lane);
  }
}

// A float32 tensor map with 128-byte swizzle: ``rank`` dims (innermost
// first), byte strides of dims 1.., the box and its element strides.
cudaError_t encode_f32(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       const cuuint32_t* unit) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
int launch(const CUtensorMap& tx, const void* whi, const void* wlo, const void* bias,
           const void* res, void* y, int k, Geometry g, int sms, int device, cudaStream_t st) {
  CUtensorMap th, tl;
  const cuuint64_t wdims[2] = {(cuuint64_t)k, (cuuint64_t)g.cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)k * 4};
  const cuuint32_t wbox[2] = {kBK, BN}, unit[2] = {1, 1};
  cudaError_t err;
  if ((err = encode_f32(&th, whi, 2, wdims, wstrides, wbox, unit)) != cudaSuccess ||
      (err = encode_f32(&tl, wlo, 2, wdims, wstrides, wbox, unit)) != cudaSuccess)
    return (int)err;
  static bool ready[64] = {};  // the shared-memory attribute, set once per device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(conv3xtf32_wgmma_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<BN>::kSmem);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  const int grid = g.total < sms ? g.total : sms;
  conv3xtf32_wgmma_kernel<BN><<<grid, kThreads, Tiles<BN>::kSmem, st>>>(
      tx, th, tl, (const float*)bias, (const float*)res, (float*)y, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) float32, NHWC; whi, wlo: (Cout, kh, kw, Cin) float32,
// the weights' TF32 hi and lo parts; bias (Cout,); res (may be null) and y:
// (B, Ho, Wo, Cout). Cin a multiple of 32; Cout of 160 or 32 (bn); all
// pointers 16-byte aligned.
extern "C" int var_conv3xtf32(const void* x, const void* whi, const void* wlo, const void* bias,
                              const void* res, void* y, int B, int H, int W, int cin, int ho,
                              int wo, int cout, int kh, int kw, int stride, int pad_t, int pad_l,
                              int bn, int sms, int device, void* stream) {
  if (cin % kBK || (bn != 160 && bn != 32) || cout % bn || (stride != 1 && stride != 2) ||
      B < 1 || ho < 1 || wo < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  g.ho = ho;
  g.wo = wo;
  g.cout = cout;
  g.stride = stride;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.kw = kw;
  g.cblocks = cin / kBK;
  g.nkb = kh * kw * g.cblocks;
  g.box_w = 1;
  while (g.box_w < wo && g.box_w < kBM) g.box_w *= 2;
  g.box_h = kBM / g.box_w;
  g.tiles_x = (wo + g.box_w - 1) / g.box_w;
  g.tiles_y = (ho + g.box_h - 1) / g.box_h;
  g.n_tiles = cout / bn;
  g.total = B * g.tiles_y * g.tiles_x * g.n_tiles;
  // the activations as (C, W, H, B), one tap's box of 32 channels x the
  // tile's pixels, every stride-th pixel in W and H
  CUtensorMap tx;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin * 4, (cuuint64_t)W * cin * 4,
                                  (cuuint64_t)H * W * cin * 4};
  const cuuint32_t xbox[4] = {kBK, (cuuint32_t)(g.box_w * stride), (cuuint32_t)(g.box_h * stride),
                              1};
  const cuuint32_t xunit[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  if ((err = encode_f32(&tx, x, 4, xdims, xstrides, xbox, xunit)) != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int k = kh * kw * cin;
  return bn == 160 ? launch<160>(tx, whi, wlo, bias, res, y, k, g, sms, device, st)
                   : launch<32>(tx, whi, wlo, bias, res, y, k, g, sms, device, st);
}
