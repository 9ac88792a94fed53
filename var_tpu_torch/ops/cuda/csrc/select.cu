// Kernel 2: sort-free exact top-k / top-p candidate bound, one block per row.
//
// Replaces var_tpu/ops/pallas/select.py::topk_topp_bound (_bound_kernel :69,
// _descend :52, float_key :42). For each row of V fp32 logits it returns
// one int32 key bound; token v is a candidate iff float_key(l_v) >= bound.
//   * float_key: sign-magnitude flip of the fp32 bits (with -0.0 taken as
//     +0.0), so that integer order is float order.
//   * top-k: a 32-step MSB descent over the unsigned key space finds the
//     largest T with #{key >= T} >= k, the exact k-th largest key; ties at
//     the k-th value are all kept.
//   * top-p: the same descent, strict, over the candidates' softmax mass:
//     the largest T with mass(key > T) >= p * M; bound = max(tk, tq + 1).
//
// Bound on the H100: memory at the single read of the row (V * 4 bytes);
// the 2 x 32 descent steps then run on the row held in shared memory, so
// device memory sees each logit once. Design: the row's keys and weights
// live in shared memory (8 * V bytes), each descent step is one pass over
// them plus one block-wide reduction (warp shuffles, then one warp over the
// per-warp partials). The step count is fixed at 32 per descent; the
// per-step barriers, not bandwidth, set this kernel's time.

#include <limits.h>

#include "common.cuh"

using namespace vtt;

#define SEL_THREADS 256

__device__ __forceinline__ int float_key(float l) {
  if (l == 0.0f) l = 0.0f;  // floats compare -0.0 == +0.0; their bits do not
  const int i = __float_as_int(l);
  return i >= 0 ? i : (i ^ 0x7FFFFFFF);
}

__device__ __forceinline__ int descend_candidate(int t, int bit) {
  // thresholds live in the int32 image of the unsigned key (u ^ 0x80000000):
  // setting unsigned bit 31 flips the int32 sign bit
  return bit == 31 ? (t ^ INT_MIN) : (t | (1 << bit));
}

__global__ void __launch_bounds__(SEL_THREADS)
topk_topp_bound_kernel(const float* __restrict__ logits, int* __restrict__ bound, int V, int k,
                       float p) {
  extern __shared__ unsigned char smem_raw[];
  int* key = reinterpret_cast<int*>(smem_raw);
  float* w = reinterpret_cast<float*>(smem_raw) + V;  // logits, then candidate masses
  __shared__ float redf[33];
  __shared__ int redi[33];

  const float* row = logits + (long long)blockIdx.x * V;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const float l = row[i];
    w[i] = l;
    key[i] = float_key(l);
    mx = fmaxf(mx, l);
  }
  mx = block_max(mx, redf);  // its barriers also publish key[] and w[]

  // top-k: largest T with #{key >= T} >= k
  int tk = INT_MIN;
  for (int bit = 31; bit >= 0; --bit) {
    const int cand = descend_candidate(tk, bit);
    int cnt = 0;
    for (int i = threadIdx.x; i < V; i += blockDim.x) cnt += key[i] >= cand;
    if (block_sum(cnt, redi) >= k) tk = cand;
  }

  int out = tk;
  if (p > 0.f) {
    // candidate masses exp(l - max) over key >= tk; every thread rewrites
    // only the slots it reads below, so no barrier is needed in between
    float local = 0.f;
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const float e = key[i] >= tk ? expf(w[i] - mx) : 0.f;
      w[i] = e;
      local += e;
    }
    const float pm = p * block_sum(local, redf);
    // top-p: largest T with mass(key > T) >= p * M; kept set is key > T
    int tq = INT_MIN;
    for (int bit = 31; bit >= 0; --bit) {
      const int cand = descend_candidate(tq, bit);
      float mass = 0.f;
      for (int i = threadIdx.x; i < V; i += blockDim.x) mass += key[i] > cand ? w[i] : 0.f;
      if (block_sum(mass, redf) >= pm) tq = cand;
    }
    out = max(tk, tq + 1);
  }
  if (threadIdx.x == 0) bound[blockIdx.x] = out;
}

extern "C" int var_topk_topp_bound(const void* logits, void* bound, long long rows, int V, int k,
                                   float p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)V * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(topk_topp_bound_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_topp_bound_kernel<<<(unsigned)rows, SEL_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (int*)bound, V, k, p);
  return (int)cudaGetLastError();
}
