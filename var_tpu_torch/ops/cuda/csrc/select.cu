// Row 3 of the kernel table (PERF.md): sort-free exact top-k / top-p
// candidate bound, one block per row.
//
// Replaces var_tpu/ops/pallas/select.py::topk_topp_bound (_bound_kernel :69,
// _descend :52, float_key :42). For each row of V fp32 logits it returns
// one int32 key bound; token v is a candidate iff float_key(l_v) >= bound.
//   * float_key: sign-magnitude flip of the fp32 bits (with -0.0 taken as
//     +0.0), so that integer order is float order.
//   * top-k: the exact k-th largest key tk, ties at the k-th value kept
//     (the largest T with #{key >= T} >= k).
//   * top-p: over the candidates' softmax mass exp(l - max), the largest
//     T with mass(key > T) >= p * M; bound = max(tk, tq + 1).
//
// Bound on the H100: memory, at the single read of the row (V * 4 bytes).
// What sets the time is a row's latency: the first decode stages launch 8
// to 128 rows, fewer than the card's 132 SMs, and a row's time is the chain
// of its passes. Design: the row is read once with 16-byte loads into
// shared memory as keys, and each of the two searches is a radix select,
// MSB first, in 4 passes of 8-bit digits over those keys. A pass builds a
// 256-bin histogram of the digit over the keys that match the digits chosen
// so far, with shared-memory integer atomics, then one warp scans the bins
// from the top and picks the digit where the running weight reaches what is
// still needed: 8 passes of 2 barriers (the histograms are double-buffered,
// the next one cleared during the current pass), against 2 x 32 block
// reductions for a bitwise descent. A pass still costs about 1 us of a
// row's time, most of it the sweep over the keys (PERF.md, row 3).
//   * top-k weighs every key 1, so its counts are exact; k = 1 takes the
//     row's max key, found while loading, and skips the passes.
//   * the top-p bound lies between tk and the max key, so top-p's passes
//     start at the first byte where the two differ (none at k = 1).
//   * top-p weighs each candidate (key >= tk) by its mass in fixed point
//     (round(m * 2^40), summed in 64 bits; m <= 1, so each mass of at least
//     2^-17 is exact and the rest err by at most 2^-41 of M = 1). Integer
//     sums do not depend on their order, so the bound is bit-identical from
//     launch to launch whatever order the atomics land in; the masses of
//     the non-candidates are never computed or added. M is the sum of the
//     first pass's bins, and p * M is compared exactly (rounded up to the
//     next integer) with the integer running sums. The mass histograms are
//     kept as 32-bit parts (MassHist): 64-bit shared atomics are
//     compare-and-swap loops that spin while the lanes of a warp contend for
//     one bin (measured: six times the time of the whole top-k search).
// The fp32 sums of the plain version take another order and round; the
// two may disagree only where mass(key >= bound) is within rounding of
// p * M (chip_smoke.py's SELECT_MASS_TOL).

#include <limits.h>

#include "common.cuh"

using namespace vtt;

namespace {

constexpr int kBins = 256;
constexpr float kMassScale = 1099511627776.0f;  // 2^40: fixed-point unit of a mass

// Count per digit (top-k). A +1 from many lanes on one bin is one
// warp-aggregated shared atomic (ATOMS.POPC.INC).
struct CountHist {
  unsigned n[kBins];
  __device__ void clear(int b) { n[b] = 0; }
  __device__ void add(int b, unsigned w) { atomicAdd(&n[b], w); }
  __device__ unsigned get(int b) const { return n[b]; }
};

// Fixed-point mass per digit (top-p), as three 32-bit sums of the mass's
// bits [0, 16), [16, 32) and [32, 41): a 64-bit shared atomic add is a
// compare-and-swap loop, which spins for as long as the lanes of a warp
// contend for one bin, while 32-bit adds are native. Fewer than 2^15 keys a
// row (select.py's _SEL_MAX_V) cannot overflow a part.
struct MassHist {
  unsigned part[3][kBins];
  __device__ void clear(int b) { part[0][b] = part[1][b] = part[2][b] = 0; }
  __device__ void add(int b, unsigned long long w) {
    atomicAdd(&part[0][b], (unsigned)w & 0xFFFFu);
    if (const unsigned mid = (unsigned)(w >> 16) & 0xFFFFu) atomicAdd(&part[1][b], mid);
    if (const unsigned top = (unsigned)(w >> 32)) atomicAdd(&part[2][b], top);
  }
  __device__ unsigned long long get(int b) const {
    return ((unsigned long long)part[2][b] << 32) + ((unsigned long long)part[1][b] << 16) +
           part[0][b];
  }
};

// Head of the dynamic shared memory; the row's V int32 keys and V fp32
// masses follow it. 8336 bytes (a multiple of 16): ops/cuda/select.py's
// _SEL_HEAD_BYTES. Each histogram is double-buffered: a pass clears the
// buffer the next pass fills.
struct SelHead {
  MassHist hist_m[2];
  CountHist hist_k[2];
  unsigned long long need;  // weight still needed below the prefix
  unsigned prefix;          // digits chosen so far (unsigned key order)
  int found;
  int warp_max[32];
};
static_assert(sizeof(SelHead) == 8336, "select.py's _SEL_HEAD_BYTES");

__device__ __forceinline__ int float_key(float l) {
  if (l == 0.0f) l = 0.0f;  // floats compare -0.0 == +0.0; their bits do not
  const int i = __float_as_int(l);
  return i >= 0 ? i : (i ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float key_float(int k) {  // float_key's inverse
  return __int_as_float(k >= 0 ? k : (k ^ 0x7FFFFFFF));
}

// Largest u in unsigned key order (key ^ 0x80000000) with W(key >= u) >= need,
// where W sums weight(i, first) over the row's keys and need is need_of(W
// of the whole row), given that the answer's top `first` bytes are those of
// prefix0 (every key of nonzero weight has them). False (and u unset) when
// the whole row weighs less. The caller has zeroed hist[0] before a
// barrier; hist[1] is zeroed here. Every thread of the block calls it.
template <int T, typename U, typename Hist, typename Weight, typename NeedOf>
__device__ __forceinline__ bool radix_select(const int* __restrict__ key, int V, Hist (&hist)[2],
                                             SelHead& s, Weight weight, NeedOf need_of,
                                             int first, unsigned prefix0, unsigned& u_out) {
  const int tid = threadIdx.x, lane = tid & 31;
#pragma unroll 1
  for (int pass = first; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const unsigned hi = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
    const unsigned prefix = pass == first ? prefix0 : s.prefix;
    Hist& cur = hist[(pass - first) & 1];
    for (int b = tid; b < kBins; b += T) hist[(pass - first + 1) & 1].clear(b);  // read last pass
    for (int i = tid; i < V; i += T) {
      const unsigned u = (unsigned)key[i] ^ 0x80000000u;
      if ((u & hi) == prefix) {
        const U w = weight(i, pass == first);
        if (w) cur.add((u >> shift) & (kBins - 1), w);
      }
    }
    __syncthreads();
    if (tid < 32) {  // lane l holds bins 255 - 8l .. 248 - 8l, highest first
      U c[8], own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = cur.get(kBins - 1 - 8 * lane - j);
        own += c[j];
      }
      U inc = own;  // inclusive running weight from the top bin down
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const U t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      const U need = pass == first ? need_of(__shfl_sync(0xffffffffu, inc, 31)) : (U)s.need;
      const unsigned hit = __ballot_sync(0xffffffffu, inc >= need);
      if (hit == 0) {
        if (lane == 0) s.found = 0;
      } else if (lane == __ffs(hit) - 1) {
        U above = inc - own;
        int d = kBins - 1 - 8 * lane;
#pragma unroll
        for (int j = 0; j < 8; ++j, --d) {
          if (above + c[j] >= need) break;
          above += c[j];
        }
        s.prefix = prefix | ((unsigned)d << shift);
        s.need = need - above;
        s.found = 1;
      }
    }
    __syncthreads();
    if (!s.found) return false;
  }
  u_out = s.prefix;
  return true;
}

template <int T>
__global__ void __launch_bounds__(T)
topk_topp_bound_kernel(const float* __restrict__ logits, int* __restrict__ bound, int V, int k,
                       float p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SelHead& s = *reinterpret_cast<SelHead*>(smem_raw);
  int* key = reinterpret_cast<int*>(smem_raw + sizeof(SelHead));
  float* mass = reinterpret_cast<float*>(key + V);
  const int tid = threadIdx.x;
  const float* row = logits + (long long)blockIdx.x * V;

  int kmax = INT_MIN;
  if ((V & 3) == 0 && ((uintptr_t)logits & 15) == 0) {  // 16-byte loads
    const float4* row4 = reinterpret_cast<const float4*>(row);
    int4* key4 = reinterpret_cast<int4*>(key);
    for (int i = tid; i < V / 4; i += T) {
      const float4 l = row4[i];
      const int4 q = make_int4(float_key(l.x), float_key(l.y), float_key(l.z), float_key(l.w));
      key4[i] = q;
      kmax = max(kmax, max(max(q.x, q.y), max(q.z, q.w)));
    }
  } else {
    for (int i = tid; i < V; i += T) {
      const int q = float_key(row[i]);
      key[i] = q;
      kmax = max(kmax, q);
    }
  }
  for (int b = tid; b < kBins; b += T) {
    s.hist_k[0].clear(b);
    s.hist_m[0].clear(b);
  }
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  if ((tid & 31) == 0) s.warp_max[tid >> 5] = kmax;
  __syncthreads();  // publishes the keys, the cleared histograms and warp_max
#pragma unroll
  for (int w = 0; w < T / 32; ++w) kmax = max(kmax, s.warp_max[w]);

  int tk = kmax;  // k = 1: the largest key
  if (k != 1) {
    unsigned u;
    const bool found = radix_select<T, unsigned>(
        key, V, s.hist_k, s, [](int, bool) { return 1u; },
        [k](unsigned) { return (unsigned)k; }, 0, 0u, u);
    tk = found ? (int)(u ^ 0x80000000u) : INT_MIN;  // k > V: every key
  }

  // Top-p: the bound lies in [tk, kmax] (some key must weigh at and above
  // it), so it shares their leading bytes, and the passes start at the
  // first byte where they differ; with tk = kmax (k = 1, or ties) it is tk.
  int out = tk;
  const unsigned lo_u = (unsigned)tk ^ 0x80000000u, hi_u = (unsigned)kmax ^ 0x80000000u;
  if (p > 0.f && lo_u != hi_u) {
    const int first = __clz(lo_u ^ hi_u) / 8;
    const unsigned prefix0 = first == 0 ? 0u : lo_u & (0xFFFFFFFFu << (32 - 8 * first));
    const float mx = key_float(kmax);
    unsigned u;
    const bool found = radix_select<T, unsigned long long>(
        key, V, s.hist_m, s,
        [&](int i, bool first_pass) -> unsigned long long {
          if (first_pass) {  // the candidates' masses, each computed once
            const int q = key[i];
            mass[i] = q >= tk ? expf(key_float(q) - mx) : 0.f;
          }
          return __float2ull_rn(mass[i] * kMassScale);
        },
        [p](unsigned long long m) {  // p * M, rounded up: the sums are integers
          return (unsigned long long)ceil((double)p * (double)m);
        },
        first, prefix0, u);
    // tq + 1 is the smallest key of the kept set key > tq
    out = max(tk, found ? (int)(u ^ 0x80000000u) : INT_MIN + 1);
  }
  if (tid == 0) bound[blockIdx.x] = out;
}

template <int T>
cudaError_t launch(const float* logits, int* bound, long long rows, int V, int k, float p,
                   cudaStream_t stream) {
  const size_t smem = sizeof(SelHead) + (size_t)V * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_topp_bound_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  topk_topp_bound_kernel<T><<<(unsigned)rows, T, smem, stream>>>(logits, bound, V, k, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int var_topk_topp_bound(const void* logits, void* bound, long long rows, int V, int k,
                                   float p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* l = (const float*)logits;
  int* b = (int*)bound;
  cudaStream_t st = (cudaStream_t)stream;
  // Up to one row per SM, a row's latency is the launch's time: spread it
  // over the most threads. With more rows the SMs share them, and smaller
  // blocks (fewer threads behind each barrier, more blocks per SM) finish
  // more rows in the same time (the thresholds were measured: PERF.md).
  if (rows <= 132) err = launch<1024>(l, b, rows, V, k, p, st);
  else if (rows <= 264) err = launch<512>(l, b, rows, V, k, p, st);
  else err = launch<256>(l, b, rows, V, k, p, st);
  return (int)err;
}
